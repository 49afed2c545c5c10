"""Content-classifier window metrics (counterpart of
audiotabs_tpu/analysis/content_classifier.py::_window_metrics).

All windows run as one batch (the JAX package vmaps one window's program).
The rule-based scoring on the host waits for the next slice.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..ops.hpss import hpss_masks
from ..ops.onset import onset_detect_frames, onset_strength
from ..ops.pyin import pyin
from ..ops.spectral import stft


def _window_metrics(windows: torch.Tensor, sr: int):
    """[W, N] batch of windows → (dispersion, onset_density, periodicity, harmonic_ratio), each [W]."""
    hop = 512
    n = windows.shape[-1]
    dur = n / sr

    # onset envelope + density
    env = onset_strength(windows, sr, hop=hop, n_fft=1024)  # [W, T]
    onsets = onset_detect_frames(env, delta=0.5, wait=4)
    onset_density = onsets.sum(dim=-1).to(torch.float32) / dur

    # periodicity: onset autocorrelation peak in the 60-200 BPM lag band
    e = env - env.mean(dim=-1, keepdim=True)
    norm = torch.linalg.vector_norm(e, dim=-1, keepdim=True)
    e = e / torch.clamp(norm, min=1e-6)
    T = e.shape[-1]
    lagged = F.pad(e, (0, T)).unfold(-1, T, 1)[..., :T, :]  # [W, lag, T]: e[t + lag]
    ac = (lagged * e[..., None, :]).sum(dim=-1)  # [W, lag]
    min_lag = max(1, int(sr * 60 / (200 * hop)))
    max_lag = max(min_lag + 1, int(sr * 60 / (60 * hop)))
    periodicity = torch.clamp(ac[..., min_lag:max_lag].max(dim=-1).values, 0.0, 1.0)
    periodicity = torch.where(norm[..., 0] < 1e-6, torch.zeros_like(periodicity), periodicity)

    # pitch dispersion (std of voiced midi pitches), E2..E6
    f0, voiced, _ = pyin(windows, sr, fmin=82.40688922821748, fmax=1318.5102276514797, frame_length=2048, hop=512)
    midi = 69.0 + 12.0 * torch.log2(torch.clamp(f0, min=1e-6) / 440.0)
    w = voiced.to(torch.float32)
    cnt = w.sum(dim=-1)
    mean = (midi * w).sum(dim=-1) / torch.clamp(cnt, min=1.0)
    var = (w * (midi - mean[..., None]) ** 2).sum(dim=-1) / torch.clamp(cnt, min=1.0)
    dispersion = torch.where(cnt >= 2, torch.sqrt(var), torch.zeros_like(var))

    # harmonic ratio via HPSS masks in the spectral domain; the whole
    # [W, F, T] batch is one median launch per direction (the JAX package
    # runs its XLA median here, use_pallas=False, as its Pallas path is 2-D only)
    S = torch.abs(stft(windows, n_fft=1024, hop=hop))
    mh, mp = hpss_masks(S, 17, 17)
    eh = ((S * mh) ** 2).sum(dim=(-2, -1))
    ep = ((S * mp) ** 2).sum(dim=(-2, -1))
    ratio = torch.where(eh + ep > 1e-9, eh / (eh + ep), torch.full_like(eh, 0.5))
    return dispersion, onset_density, periodicity, ratio
