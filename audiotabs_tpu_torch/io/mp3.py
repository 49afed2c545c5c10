"""MP3 decoding via the system libmpg123, bound with ctypes.

Counterpart of audiotabs_tpu/io/mp3.py: the decoder streams straight into a
numpy buffer (no subprocess, no temporary WAV). ``mp3_available`` is False
when the library is absent, and the callers then try the next decoder.
"""

from __future__ import annotations

import ctypes
import os
from pathlib import Path

import numpy as np

_MPG123_ENC_SIGNED_16 = 0x040 | 0x080 | 0x10  # mpg123.h MPG123_ENC_SIGNED_16
_MPG123_OK = 0
_MPG123_DONE = -12
_MPG123_NEW_FORMAT = -11

_LIB_CANDIDATES = ("libmpg123.so.0", "libmpg123.so", "libmpg123.dylib")
_lib: ctypes.CDLL | None = None
_lib_checked = False


def _load_lib() -> ctypes.CDLL | None:
    global _lib, _lib_checked
    if _lib_checked:
        return _lib
    _lib_checked = True
    for name in _LIB_CANDIDATES:
        try:
            lib = ctypes.CDLL(name)
        except OSError:
            continue
        lib.mpg123_init.restype = ctypes.c_int
        lib.mpg123_new.restype = ctypes.c_void_p
        lib.mpg123_new.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_int)]
        lib.mpg123_open.restype = ctypes.c_int
        lib.mpg123_open.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
        lib.mpg123_getformat.restype = ctypes.c_int
        lib.mpg123_getformat.argtypes = [
            ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_long),
            ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int),
        ]
        lib.mpg123_format_none.restype = ctypes.c_int
        lib.mpg123_format_none.argtypes = [ctypes.c_void_p]
        lib.mpg123_format.restype = ctypes.c_int
        lib.mpg123_format.argtypes = [
            ctypes.c_void_p, ctypes.c_long, ctypes.c_int, ctypes.c_int,
        ]
        lib.mpg123_read.restype = ctypes.c_int
        lib.mpg123_read.argtypes = [
            ctypes.c_void_p,
            ctypes.c_void_p,
            ctypes.c_size_t,
            ctypes.POINTER(ctypes.c_size_t),
        ]
        lib.mpg123_close.restype = ctypes.c_int
        lib.mpg123_close.argtypes = [ctypes.c_void_p]
        lib.mpg123_delete.restype = None
        lib.mpg123_delete.argtypes = [ctypes.c_void_p]
        lib.mpg123_init()
        _lib = lib
        break
    return _lib


def mp3_available() -> bool:
    return _load_lib() is not None


def looks_like_mp3(path: str | os.PathLike) -> bool:
    """ID3 tag or an MPEG audio frame sync at the start."""
    try:
        with open(path, "rb") as f:
            hdr = f.read(3)
    except OSError:
        return False
    if hdr[:3] == b"ID3":
        return True
    return len(hdr) >= 2 and hdr[0] == 0xFF and (hdr[1] & 0xE0) == 0xE0


def decode_mp3(path: str | os.PathLike, mono: bool = True) -> tuple[np.ndarray, int]:
    """Decode an MP3 file → (float32 samples in [-1, 1], sample_rate).

    Stereo is downmixed to mono when ``mono`` (matching the reference's
    `-ac 1` ffmpeg decode).
    """
    lib = _load_lib()
    if lib is None:
        raise RuntimeError("libmpg123 not available: cannot decode MP3")
    path = Path(path)
    err = ctypes.c_int(0)
    h = lib.mpg123_new(None, ctypes.byref(err))
    if not h:
        raise RuntimeError(f"mpg123_new failed: {err.value}")
    try:
        if lib.mpg123_open(h, str(path).encode()) != _MPG123_OK:
            raise RuntimeError(f"mpg123_open failed for {path}")
        rate = ctypes.c_long(0)
        channels = ctypes.c_int(0)
        encoding = ctypes.c_int(0)
        if lib.mpg123_getformat(h, ctypes.byref(rate), ctypes.byref(channels), ctypes.byref(encoding)) != _MPG123_OK:
            raise RuntimeError("mpg123_getformat failed")
        # lock the output format to s16 at the stream's native rate
        lib.mpg123_format_none(h)
        lib.mpg123_format(h, rate.value, channels.value, _MPG123_ENC_SIGNED_16)

        chunks: list[np.ndarray] = []
        buf = (ctypes.c_char * 65536)()
        done = ctypes.c_size_t(0)
        while True:
            ret = lib.mpg123_read(h, buf, len(buf), ctypes.byref(done))
            if done.value:
                chunks.append(np.frombuffer(buf.raw[: done.value], dtype="<i2").copy())
            if ret == _MPG123_NEW_FORMAT:
                lib.mpg123_getformat(h, ctypes.byref(rate), ctypes.byref(channels), ctypes.byref(encoding))
                continue
            if ret == _MPG123_DONE:
                break
            if ret not in (_MPG123_OK,):
                raise RuntimeError(f"mpg123_read error: {ret}")
    finally:
        lib.mpg123_close(h)
        lib.mpg123_delete(h)

    if not chunks:
        raise RuntimeError(f"no audio decoded from {path}")
    pcm = np.concatenate(chunks).astype(np.float32) / 32768.0
    ch = max(1, channels.value)
    if ch > 1:
        pcm = pcm[: len(pcm) - len(pcm) % ch].reshape(-1, ch)
        if mono:
            pcm = pcm.mean(axis=1)
    return pcm, int(rate.value)
