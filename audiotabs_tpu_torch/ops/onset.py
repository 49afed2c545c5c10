"""Onset strength and onset detection (spectral flux + peak pick).

Counterpart of audiotabs_tpu/ops/onset.py. The refractory ``wait`` rule,
a lax.scan in JAX, is one launch of the CUDA kernel csrc/onset_wait.cu for
every envelope of a batch on the card (``_wait``), and a plain loop over
frames on the CPU (``_wait_plain``). The candidate frames (local maximum
and mean plus delta) are torch operations on either device.
"""

from __future__ import annotations

import ctypes
import operator

import torch
import torch.nn.functional as F

from .. import _build
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


_ARGTYPES = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
INT32_MAX = 2**31 - 1


def _kernel_wait(wait: int, T: int) -> int:
    """The kernel's wait for ``wait`` over rows of T frames: the same rule,
    within a C int. A wait of -1 or less fires every candidate, as does -1;
    one of T or more fires only a row's first candidate, as does T."""
    return max(-1, min(operator.index(wait), T))


def _launch_args(cand: torch.Tensor, wait: int) -> tuple:
    """The kernel's arguments for bool candidates [..., T] on the card: the
    contiguous input, the output and the kernel's wait. Raises, before
    anything is allocated, for a wait that is not an integer (TypeError) and
    a shape the kernel does not take (ValueError)."""
    T = cand.shape[-1]
    rows = cand.numel() // T
    wait = _kernel_wait(wait, T)
    if T > INT32_MAX or rows > INT32_MAX:
        raise ValueError(f"the onset wait kernel takes fewer than 2**31 rows and frames, got {rows} rows of {T}")
    c = cand.contiguous()
    return c, torch.empty_like(c), wait


def _wait_cuda(cand: torch.Tensor, wait: int) -> torch.Tensor:
    """The rule on the card: one launch, one warp per row; none for an empty input."""
    if cand.numel() == 0:
        return torch.zeros_like(cand)
    c, fired, wait = _launch_args(cand, wait)
    _build.launch("onset_wait", "onset_wait_u8", _ARGTYPES, c.device, c, fired, c.numel() // c.shape[-1], c.shape[-1], wait)
    return fired


def _wait(cand: torch.Tensor, wait: int) -> torch.Tensor:
    """The refractory rule over bool candidates [..., T]: the kernel for a
    CUDA tensor, the plain loop for a CPU tensor; any other device raises."""
    if cand.dtype != torch.bool:
        raise TypeError(f"the wait rule takes bool candidates, got {cand.dtype}")
    return _build.plain_or_kernel("onset_detect_frames", _wait_plain, _wait_cuda, cand, wait)
