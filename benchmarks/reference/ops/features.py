"""Frame-level spectral features: mel, RMS, centroid, rolloff.

Counterpart of audiotabs_tpu/ops/features.py. The mel filterbank is built in
numpy exactly as there (f64 band edges, f32 bank) and moved to the device.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from .spectral import as_device, frame, stft


def _hz_to_mel(f):
    return 2595.0 * np.log10(1.0 + np.asarray(f) / 700.0)


def _mel_to_hz(m):
    return 700.0 * (10.0 ** (np.asarray(m) / 2595.0) - 1.0)


_SLANEY_LOGSTEP = np.log(6.4) / 27.0


def _hz_to_mel_slaney(f):
    """Slaney-scale mel (librosa's default): linear below 1 kHz, log above."""
    f = np.asarray(f, dtype=np.float64)
    return np.where(
        f >= 1000.0,
        15.0 + np.log(np.maximum(f, 1e-9) / 1000.0) / _SLANEY_LOGSTEP,
        f / (200.0 / 3.0),
    )


def _mel_to_hz_slaney(m):
    m = np.asarray(m, dtype=np.float64)
    return np.where(m >= 15.0, 1000.0 * np.exp(_SLANEY_LOGSTEP * (m - 15.0)), m * (200.0 / 3.0))


@lru_cache(maxsize=8)
def mel_filterbank(
    sr: int,
    n_fft: int,
    n_mels: int = 128,
    fmin: float = 0.0,
    fmax: float | None = None,
    scale: str = "htk",
) -> np.ndarray:
    """Triangular mel filterbank [n_mels, n_fft//2+1], area-normalised (numpy f32).

    Parity trap: the band edges are computed in f64 and the bank cast to f32,
    as in the JAX package; building it in f32 moves the edges."""
    fmax = fmax or sr / 2.0
    n_freqs = n_fft // 2 + 1
    fft_freqs = np.linspace(0.0, sr / 2.0, n_freqs)
    h2m, m2h = (_hz_to_mel_slaney, _mel_to_hz_slaney) if scale == "slaney" else (_hz_to_mel, _mel_to_hz)
    mel_pts = np.linspace(h2m(fmin), h2m(fmax), n_mels + 2)
    hz_pts = m2h(mel_pts)
    fb = np.zeros((n_mels, n_freqs), dtype=np.float32)
    for i in range(n_mels):
        lo, ctr, hi = hz_pts[i], hz_pts[i + 1], hz_pts[i + 2]
        up = (fft_freqs - lo) / max(ctr - lo, 1e-9)
        down = (hi - fft_freqs) / max(hi - ctr, 1e-9)
        fb[i] = np.maximum(0.0, np.minimum(up, down))
        fb[i] *= 2.0 / max(hi - lo, 1e-9)
    return fb


def melspectrogram(y: torch.Tensor, sr: int, n_fft: int = 2048, hop: int = 512, n_mels: int = 128, power: float = 2.0):
    S = torch.abs(stft(y, n_fft=n_fft, hop=hop)) ** power  # [..., F, T]
    return as_device(mel_filterbank(sr, n_fft, n_mels), y) @ S


def rms(y: torch.Tensor, frame_length: int = 2048, hop: int = 512):
    frames = frame(y, frame_length, hop, center=True)  # [..., nf, L]
    return torch.sqrt(torch.mean(frames**2, dim=-1))


def _freqs(sr: int, n: int, like: torch.Tensor) -> torch.Tensor:
    return torch.linspace(0.0, sr / 2.0, n, dtype=torch.float32, device=like.device)


def spectral_centroid(y: torch.Tensor, sr: int, n_fft: int = 2048, hop: int = 512):
    S = torch.abs(stft(y, n_fft=n_fft, hop=hop))  # [..., F, T]
    w = S / torch.clamp(S.sum(dim=-2, keepdim=True), min=1e-10)
    return torch.einsum("f,...ft->...t", _freqs(sr, S.shape[-2], y), w)


def spectral_rolloff(y: torch.Tensor, sr: int, n_fft: int = 2048, hop: int = 512, roll_percent: float = 0.85):
    S = torch.abs(stft(y, n_fft=n_fft, hop=hop))
    cum = torch.cumsum(S, dim=-2)
    over = cum >= roll_percent * cum[..., -1:, :]
    # first frequency index where the cumulative energy crosses the threshold
    # (argmax returns the first maximum, as jnp.argmax does)
    idx = torch.argmax(over.to(torch.uint8), dim=-2)
    return _freqs(sr, S.shape[-2], y)[idx]
