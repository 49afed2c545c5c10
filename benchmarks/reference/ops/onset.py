"""Onset strength and onset detection (spectral flux + peak pick).

The refractory ``wait`` rule is a plain loop over frames on every device
(``_wait_plain``). The candidate frames (local maximum and mean plus delta)
are torch operations.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .features import melspectrogram
from .spectral import power_to_db

def onset_strength(y: torch.Tensor, sr: int, hop: int = 512, n_fft: int = 2048, n_mels: int = 128, lag: int = 1):
    """Half-wave-rectified dB mel flux, mean over bands → [..., T]."""
    S = power_to_db(melspectrogram(y, sr, n_fft=n_fft, hop=hop, n_mels=n_mels), top_db=None)
    diff = S[..., :, lag:] - S[..., :, :-lag]
    flux = torch.clamp(diff, min=0.0).mean(dim=-2)
    return F.pad(flux, (lag, 0))


def _sliding_reduce(x: torch.Tensor, pre: int, post: int, kind: str):
    """Max/mean over window [t-pre, t+post] along the last axis."""
    win = pre + post + 1
    pad_val = float("-inf") if kind == "max" else 0.0
    w = F.pad(x, (pre, post), value=pad_val).unfold(-1, win, 1)  # [..., T, win]
    if kind == "max":
        return w.max(dim=-1).values
    # mean ignoring the padded region near the edges: window [t-pre, t+post]
    # holds min(t, pre) + min(T-1-t, post) + 1 valid samples
    T = x.shape[-1]
    t_idx = torch.arange(T, device=x.device)
    count = torch.minimum(t_idx + post + 1, T - t_idx + pre)
    count = torch.clamp(count, max=win).to(x.dtype)
    return w.sum(dim=-1) / count


def onset_detect_frames(
    env: torch.Tensor,
    pre_max: int = 3,
    post_max: int = 3,
    pre_avg: int = 3,
    post_avg: int = 5,
    delta: float = 0.07,
    wait: int = 3,
):
    """Peak-pick an onset envelope [..., T] → boolean onset mask [..., T]."""
    local_max = _sliding_reduce(env, pre_max, post_max, "max")
    local_avg = _sliding_reduce(env, pre_avg, post_avg, "mean")
    cand = (env >= local_max) & (env >= local_avg + delta)
    return _wait(cand, wait)


def _wait_plain(cand: torch.Tensor, wait: int) -> torch.Tensor:
    """The plain version: a frame fires when it is a candidate and more than
    ``wait`` frames have passed since the last one that fired."""
    T = cand.shape[-1]
    last = torch.full(cand.shape[:-1], -wait - 1, dtype=torch.int64, device=cand.device)
    fired = torch.zeros_like(cand)
    for t in range(T):
        fire = cand[..., t] & (t - last > wait)
        last = torch.where(fire, t, last)
        fired[..., t] = fire
    return fired


def _wait(cand: torch.Tensor, wait: int) -> torch.Tensor:
    """The refractory rule over bool candidates [..., T]: the plain loop on every device."""
    if cand.dtype != torch.bool:
        raise TypeError(f"the wait rule takes bool candidates, got {cand.dtype}")
    return _wait_plain(cand, wait)
