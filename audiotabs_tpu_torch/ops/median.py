"""Sliding-window median along one of the last two axes, for HPSS.

The CUDA kernel (``csrc/median_filter.cu``) replaces the TPU kernel
``audiotabs_tpu/ops/pallas_median.py::_median_kernel``: an exact,
edge-replicated, odd-window median of float32 data. It reads the window along
either axis of an [F, T] or [B, F, T] tensor through its strides, so the
frequency-direction median needs no transposed copy and a batch is a grid
index. What bounds it on the card, and what its design does about that, is
written at the top of the CUDA source.

``median_filter`` launches the kernel for a CUDA tensor and takes the plain
PyTorch version for a CPU tensor; there is no fallback from one to the other.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from .. import _build

# Launches of the CUDA kernel in this process; only median_filter adds to it.
LAUNCHES = 0

_FN = None


def _kernel():
    global _FN
    if _FN is None:
        fn = _build.load("median_filter").median_filter_f32
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def build() -> None:
    """Compile and load the kernel now (it is otherwise built at first use)."""
    _kernel()


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
    """Median over a window of ``win`` along ``axis`` (-1 or -2), edges replicated.

    CUDA tensors (contiguous float32) launch the kernel; CPU tensors take
    median_filter_plain. Any other device raises."""
    global LAUNCHES
    axis = _check(x, win, axis)
    if x.device.type == "cpu":
        return median_filter_plain(x, win, axis)
    if x.device.type != "cuda":
        raise ValueError(f"median_filter runs on cuda or cpu, got {x.device}")
    if not x.is_contiguous():
        raise ValueError("median_filter needs a contiguous tensor")
    batch = x.shape[0] if x.ndim == 3 else 1
    n_slow, n_fast = x.shape[-2], x.shape[-1]
    y = torch.empty_like(x)
    fn = _kernel()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(x.data_ptr(), y.data_ptr(), batch, n_slow, n_fast, win, int(axis == x.ndim - 1), stream)
    if rc != 0:
        raise RuntimeError(f"median_filter kernel launch failed (cudaError {rc})")
    LAUNCHES += 1
    return y
