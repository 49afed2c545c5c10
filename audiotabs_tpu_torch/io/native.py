"""ctypes bindings for the C++ audio library (native/audiotabs_native.cpp).

Counterpart of audiotabs_tpu/io/native.py: a fast host WAV decode and the
windowed-sinc polyphase resampler. The library is built from the repo's
``native/audiotabs_native.cpp`` with ``g++ -O3 -shared -fPIC`` (the JAX
package's flags) into ``build/`` at first use (``_build.build_native``).
Every entry point returns None when the library is unavailable (no
compiler, or ``AUDIOTABS_DISABLE_NATIVE`` set), and the callers take their
pure-Python fallback (io/wav.py, io/resample.py), as in the JAX package.
"""

from __future__ import annotations

import ctypes
import logging
import math
import os
import threading
from pathlib import Path

import numpy as np

from .._build import PACKAGE_DIR, build_native

_LOG = logging.getLogger(__name__)

SOURCE = PACKAGE_DIR.parent / "native" / "audiotabs_native.cpp"
FLAGS = ("-O3", "-shared", "-fPIC")
_LOCK = threading.Lock()
_lib: ctypes.CDLL | None = None
_tried = False


def _load() -> ctypes.CDLL | None:
    try:
        lib = ctypes.CDLL(str(build_native(SOURCE, "g++", FLAGS)))
    except Exception as exc:
        _LOG.info("native library unavailable: %s", exc)
        return None
    lib.atn_read_wav.restype = ctypes.c_int
    lib.atn_read_wav.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_int,
        ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32),
    ]
    lib.atn_free.argtypes = [ctypes.POINTER(ctypes.c_float)]
    lib.atn_resample.restype = ctypes.c_int64
    lib.atn_resample.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
        ctypes.c_int32, ctypes.c_int32,
        ctypes.POINTER(ctypes.c_float), ctypes.c_int32,
    ]
    lib.atn_peak_normalize.argtypes = [ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_float]
    return lib


def get_lib() -> ctypes.CDLL | None:
    """The library, built and loaded once per process; None when
    ``AUDIOTABS_DISABLE_NATIVE`` is set or it cannot be built."""
    global _lib, _tried
    if os.environ.get("AUDIOTABS_DISABLE_NATIVE"):
        return None
    with _LOCK:
        if not _tried:
            _tried = True
            _lib = _load()
    return _lib


def read_wav_native(path: str | os.PathLike, mono: bool = True):
    """→ (float32 array, sample_rate) or None when the native lib is absent
    or the format is unsupported."""
    lib = get_lib()
    if lib is None:
        return None
    data = Path(path).read_bytes()
    out = ctypes.POINTER(ctypes.c_float)()
    n = ctypes.c_int64()
    ch = ctypes.c_int32()
    sr = ctypes.c_int32()
    rc = lib.atn_read_wav(data, len(data), 1 if mono else 0, ctypes.byref(out), ctypes.byref(n), ctypes.byref(ch), ctypes.byref(sr))
    if rc != 0:
        return None
    try:
        arr = np.ctypeslib.as_array(out, shape=(n.value * ch.value,)).copy()
    finally:
        lib.atn_free(out)
    if not mono and ch.value > 1:
        arr = arr.reshape(n.value, ch.value)
    return arr, int(sr.value)


def resample_native(x: np.ndarray, sr_in: int, sr_out: int, taps_per_phase: int = 24):
    """Polyphase resample via the native lib, or None when unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    g = math.gcd(sr_in, sr_out)
    up, down = sr_out // g, sr_in // g
    if up > 1024 or down > 1024:
        return None  # absurd ratio; let scipy handle it
    x = np.ascontiguousarray(x, dtype=np.float32)
    out = np.empty(len(x) * up // down + 8, dtype=np.float32)
    written = lib.atn_resample(
        x.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), len(x), up, down,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), taps_per_phase,
    )
    return out[:written]
