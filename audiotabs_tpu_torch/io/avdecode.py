"""Any-container audio decode through the FFmpeg libraries.

Counterpart of audiotabs_tpu/io/avdecode.py. The shim
``native/audiotabs_decode.c`` is built with ``gcc -O2 -shared -fPIC ...
-lavformat -lavcodec -lavutil -lswresample`` into ``build/`` at first use,
only when the libavformat headers exist (the test of ``native/build.sh``).
Otherwise ``av_available`` is False and the callers fall back to the
format-specific decoders and then an ``ffmpeg`` binary, as in the JAX package.
"""

from __future__ import annotations

import ctypes
import logging
import os
import threading
from pathlib import Path

import numpy as np

from .._build import PACKAGE_DIR, build_native

_LOG = logging.getLogger(__name__)

SOURCE = PACKAGE_DIR.parent / "native" / "audiotabs_decode.c"
FLAGS = ("-O2", "-shared", "-fPIC")
LIBS = ("-lavformat", "-lavcodec", "-lavutil", "-lswresample")
HEADERS = (Path("/usr/include/x86_64-linux-gnu/libavformat/avformat.h"), Path("/usr/include/libavformat/avformat.h"))
_LOCK = threading.Lock()
_lib: ctypes.CDLL | None = None
_lib_checked = False


def headers_present() -> bool:
    return any(h.exists() for h in HEADERS)


def _load_lib() -> ctypes.CDLL | None:
    global _lib, _lib_checked
    with _LOCK:
        if _lib_checked:
            return _lib
        _lib_checked = True
        if not headers_present():
            return None
        try:
            lib = ctypes.CDLL(str(build_native(SOURCE, "gcc", FLAGS, LIBS)))
        except Exception as exc:
            _LOG.info("FFmpeg decode shim unavailable: %s", exc)
            return None
        lib.at_decode_audio.restype = ctypes.c_int
        lib.at_decode_audio.argtypes = [
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
            ctypes.POINTER(ctypes.c_longlong),
            ctypes.POINTER(ctypes.c_int),
        ]
        lib.at_free.restype = None
        lib.at_free.argtypes = [ctypes.POINTER(ctypes.c_float)]
        _lib = lib
        return _lib


def av_available() -> bool:
    return _load_lib() is not None


def decode_any(path: str | os.PathLike) -> tuple[np.ndarray, int]:
    """Decode any container's first audio stream → (mono float32, rate)."""
    lib = _load_lib()
    if lib is None:
        raise RuntimeError("libaudiotabs_decode unavailable")
    buf = ctypes.POINTER(ctypes.c_float)()
    n = ctypes.c_longlong(0)
    sr = ctypes.c_int(0)
    ret = lib.at_decode_audio(str(path).encode(), ctypes.byref(buf), ctypes.byref(n), ctypes.byref(sr))
    if ret != 0:
        raise RuntimeError(f"decode failed for {path} (code {ret})")
    try:
        out = np.ctypeslib.as_array(buf, shape=(n.value,)).astype(np.float32, copy=True)
    finally:
        lib.at_free(buf)
    return out, int(sr.value)
