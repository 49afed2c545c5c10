"""Harmonic/percussive separation by median filtering.

Counterpart of audiotabs_tpu/ops/hpss.py. The time- and frequency-direction
medians go through ops/median.py, the plain version on every device.
"""

from __future__ import annotations

import torch

from .median import median_filter
from .spectral import istft, stft


def hpss_masks(S_mag: torch.Tensor, kernel_harm: int = 31, kernel_perc: int = 31, power: float = 2.0):
    """Soft harmonic/percussive masks from a magnitude spectrogram [..., F, T]."""
    S_mag = S_mag.contiguous()
    harm = median_filter(S_mag, kernel_harm, -1)  # median over time
    perc = median_filter(S_mag, kernel_perc, -2)  # median over frequency
    hp = harm**power
    pp = perc**power
    tot = hp + pp
    safe = tot > 1e-10
    mask_h = torch.where(safe, hp / torch.where(safe, tot, torch.ones_like(tot)), torch.full_like(tot, 0.5))
    return mask_h, 1.0 - mask_h


def hpss(y: torch.Tensor, n_fft: int = 2048, hop: int = 512, kernel: int = 31, power: float = 2.0):
    """Split a waveform into (harmonic, percussive) components."""
    S = stft(y, n_fft=n_fft, hop=hop)
    mh, mp = hpss_masks(torch.abs(S), kernel, kernel, power)
    length = y.shape[-1]
    return istft(S * mh, hop=hop, length=length), istft(S * mp, hop=hop, length=length)


def harmonic(y: torch.Tensor, n_fft: int = 2048, hop: int = 512, kernel: int = 31, power: float = 2.0):
    """Harmonic component only (reference: librosa.effects.harmonic)."""
    S = stft(y, n_fft=n_fft, hop=hop)
    mh, _ = hpss_masks(torch.abs(S), kernel, kernel, power)
    return istft(S * mh, hop=hop, length=y.shape[-1])
