"""Host-side rational resampling (numpy).

``resample_poly_host`` is the windowed-sinc polyphase filter of the JAX
package's native resampler (``native/audiotabs_native.cpp::atn_resample``,
24 taps per phase, Kaiser beta 8.6), computed with the filter bank of
``_polyphase_bank`` in numpy, so the port needs neither the native library
nor scipy.
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np


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


def resample_poly_host(x: np.ndarray, sr_in: int, sr_out: int, taps_per_phase: int = 24) -> np.ndarray:
    """Resample mono float audio from sr_in to sr_out → float32 [len·up//down].

    Output t takes phase p = (t·down) mod up and centre k = (t·down) div up;
    y[t] = Σ_m x[k + taps/2 − m] · bank[p, m], with samples outside the
    signal read as zero."""
    x = np.asarray(x, dtype=np.float32)
    if sr_in == sr_out:
        return x
    g = math.gcd(sr_in, sr_out)
    up, down = sr_out // g, sr_in // g
    bank = _polyphase_bank(up, down, taps_per_phase).astype(np.float64)  # [up, taps]
    n_taps = bank.shape[1]
    n_out = len(x) * up // down
    t = np.arange(n_out, dtype=np.int64)
    phase = (t * down) % up
    centre = (t * down) // up
    xp = np.concatenate([np.zeros(n_taps), x.astype(np.float64), np.zeros(n_taps)])
    out = np.zeros(n_out, dtype=np.float64)
    for m in range(n_taps):
        out += xp[centre + taps_per_phase // 2 - m + n_taps] * bank[phase, m]
    return out.astype(np.float32)
