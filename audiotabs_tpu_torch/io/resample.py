"""Host-side rational resampling (numpy).

Counterpart of audiotabs_tpu/io/resample.py::resample_poly_host: the native
library's windowed-sinc polyphase resampler (io/native.py, 24 taps per
phase, Kaiser beta 8.6) when it is built, else ``scipy.signal.resample_poly``,
as the JAX package routes it.
"""

from __future__ import annotations

import math

import numpy as np


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
