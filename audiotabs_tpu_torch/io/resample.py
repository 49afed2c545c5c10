"""Sample-rate conversion: on the host, and on the device.

Counterpart of audiotabs_tpu/io/resample.py. ``resample_poly_host`` is the
native library's windowed-sinc polyphase resampler (io/native.py, 24 taps
per phase, Kaiser beta 8.6) when it is built, else
``scipy.signal.resample_poly``, as the JAX package routes it; every path of
the port resamples there. ``resample_kernel`` is the JAX
``resample_kernel_jax`` on a tensor's device: the same polyphase bank, the
same [T_out, taps] gather and the same row-wise product.
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch

from ..ops.spectral import as_device


def resample_poly_host(x: np.ndarray, sr_in: int, sr_out: int) -> np.ndarray:
    """Polyphase resampling on the host (C++ fast path, scipy fallback)."""
    if sr_in == sr_out:
        return np.asarray(x, dtype=np.float32)
    from .native import resample_native

    y = resample_native(x, sr_in, sr_out)
    if y is not None:
        return y
    from scipy.signal import resample_poly

    g = math.gcd(sr_in, sr_out)
    return resample_poly(np.asarray(x, dtype=np.float64), sr_out // g, sr_in // g).astype(np.float32)


@lru_cache(maxsize=16)
def _polyphase_bank(up: int, down: int, taps_per_phase: int = 24) -> np.ndarray:
    """Windowed-sinc filter bank [up, taps] for rational rate up/down."""
    cutoff = min(1.0 / up, 1.0 / down)
    half = taps_per_phase * up // 2
    n = np.arange(-half, half + 1, dtype=np.float64)
    h = up * cutoff * np.sinc(cutoff * n)
    h *= np.kaiser(len(n), beta=8.6)
    # pad to a multiple of up and fold into phases
    pad = (-len(h)) % up
    h = np.concatenate([h, np.zeros(pad)])
    bank = h.reshape(-1, up).T[:, ::-1]  # [up, taps], time-reversed for dot
    return np.ascontiguousarray(bank[:, ::-1]).astype(np.float32)


def resample_kernel(x: torch.Tensor, sr_in: int, sr_out: int) -> torch.Tensor:
    """Rational resampling of x [..., T] on its device as a gather and a product.

    For each output sample t: phase p = (t*down) % up, input offset
    k = (t*down) // up; y[t] = dot(bank[p], x[k - taps//2 : ...]), with
    samples outside x taken as zero."""
    if sr_in == sr_out:
        return x
    g = math.gcd(sr_in, sr_out)
    up, down = sr_out // g, sr_in // g
    bank = _polyphase_bank(up, down)  # [up, taps]
    taps = bank.shape[1]
    n_in = x.shape[-1]
    n_out = int(n_in * up // down)

    t = torch.arange(n_out, device=x.device)
    phase = (t * down) % up
    base = (t * down) // up - taps // 2
    idx = base[:, None] + torch.arange(taps, device=x.device)[None, :]  # [T_out, taps]
    valid = (idx >= 0) & (idx < n_in)
    gathered = torch.where(valid, x[..., idx.clamp(0, n_in - 1)], 0.0)  # [..., T_out, taps]
    coeffs = as_device(bank, x)[phase]  # [T_out, taps]
    return torch.sum(gathered * coeffs, dim=-1)
