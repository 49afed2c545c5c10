"""Sliding-window median along one of the last two axes, for HPSS: the
plain PyTorch version (replicate-pad, unfold, median) on every device."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _check(x: torch.Tensor, win: int, axis: int) -> int:
    if x.dtype != torch.float32:
        raise TypeError(f"median_filter takes float32, got {x.dtype}")
    if x.ndim not in (2, 3):
        raise ValueError(f"median_filter takes [F, T] or [B, F, T], got shape {tuple(x.shape)}")
    if not (isinstance(win, int) and win % 2 == 1 and 1 <= win < 128):
        raise ValueError(f"window must be an odd int below 128, got {win!r}")
    if axis not in (-1, -2, x.ndim - 1, x.ndim - 2):
        raise ValueError(f"axis must be one of the last two, got {axis}")
    return axis % x.ndim


def median_filter_plain(x: torch.Tensor, win: int, axis: int = -1) -> torch.Tensor:
    """The plain version: replicate-pad, unfold the window, take its median.

    For an odd window torch.median returns the exact middle element, as
    jnp.median does (audiotabs_tpu/ops/hpss.py:_median_filter_lastaxis)."""
    axis = _check(x, win, axis)
    xt = x if axis == x.ndim - 1 else x.transpose(-1, -2)
    lead = xt.shape[:-1]
    half = win // 2
    xp = F.pad(xt.reshape(1, -1, xt.shape[-1]), (half, half), mode="replicate")
    med = xp.unfold(-1, win, 1).median(dim=-1).values.reshape(*lead, xt.shape[-1])
    return med if axis == x.ndim - 1 else med.transpose(-1, -2).contiguous()


def median_filter(x: torch.Tensor, win: int, axis: int = -1) -> torch.Tensor:
    """Median over a window of ``win`` along ``axis`` (-1 or -2), edges replicated."""
    return median_filter_plain(x, win, axis)
