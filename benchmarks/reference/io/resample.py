"""Sample-rate conversion on the host: the windowed-sinc polyphase resampler
(24 taps a phase, a Kaiser window of beta 8.6) in numpy, with the same
float64 filter taps and the same order of float64 additions for each output
sample as the C++ library the program loads (``native/audiotabs_native.cpp``,
``atn_resample``), so both give the same float32 samples."""

from __future__ import annotations

import math

import numpy as np


def _bessel_i0(x: float) -> float:
    total, term = 1.0, 1.0
    for k in range(1, 32):
        term *= (x / (2.0 * k)) * (x / (2.0 * k))
        total += term
        if term < 1e-12 * total:
            break
    return total


def _sinc(x: float) -> float:
    if x == 0.0:
        return 1.0
    px = math.pi * x
    return math.sin(px) / px


def resample_poly_host(x: np.ndarray, sr_in: int, sr_out: int, taps_per_phase: int = 24) -> np.ndarray:
    """Rational resampling of mono ``x`` from ``sr_in`` to ``sr_out``."""
    x = np.asarray(x, dtype=np.float32)
    if sr_in == sr_out:
        return x
    g = math.gcd(sr_in, sr_out)
    up, down = sr_out // g, sr_in // g
    cutoff = 1.0 / max(up, down)
    half = taps_per_phase * up // 2
    n_taps = 2 * half + 1
    i0b = _bessel_i0(8.6)
    h = np.array([
        up * cutoff * _sinc(cutoff * n) * (_bessel_i0(8.6 * math.sqrt(1.0 - (n / half) * (n / half))) / i0b)
        for n in (float(i - half) for i in range(n_taps))
    ])
    n_in = len(x)
    num = np.arange(n_in * up // down, dtype=np.int64) * down
    k0, phase = num // up, num % up
    x64 = x.astype(np.float64)
    acc = np.zeros(len(num))
    for j in range(-(taps_per_phase // 2), taps_per_phase // 2 + 1):
        k, hi = k0 - j, half + j * up + phase
        ok = (k >= 0) & (k < n_in) & (hi >= 0) & (hi < n_taps)
        acc += np.where(ok, x64[np.clip(k, 0, n_in - 1)] * h[np.clip(hi, 0, n_taps - 1)], 0.0)
    return acc.astype(np.float32)
