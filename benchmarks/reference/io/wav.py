"""Host-side audio decoding (numpy): the RIFF/WAVE reader (``read_wav``),
``load_wav``, ``peak_normalize`` and the analysis decode of a WAV upload."""

from __future__ import annotations

import os
import struct
from pathlib import Path

import numpy as np

from .resample import resample_poly_host

_WAVE_FORMAT_PCM = 0x0001
_WAVE_FORMAT_IEEE_FLOAT = 0x0003
_WAVE_FORMAT_EXTENSIBLE = 0xFFFE


def read_wav(path: str | os.PathLike) -> tuple[np.ndarray, int]:
    """Read a RIFF/WAVE file → (float32 array [samples, channels], sample_rate)."""
    data = Path(path).read_bytes()
    if len(data) < 44 or data[:4] != b"RIFF" or data[8:12] != b"WAVE":
        raise ValueError(f"not a RIFF/WAVE file: {path}")
    pos = 12
    fmt = fmt_body = raw = None
    n = len(data)
    while pos + 8 <= n:
        cid = data[pos : pos + 4]
        (size,) = struct.unpack_from("<I", data, pos + 4)
        body = data[pos + 8 : pos + 8 + size]
        if cid == b"fmt ":
            fmt = struct.unpack_from("<HHIIHH", body, 0)
            fmt_body = body
        elif cid == b"data":
            raw = body
        pos += 8 + size + (size & 1)  # chunks are word-aligned
        if fmt is not None and raw is not None:
            break
    if fmt is None or raw is None:
        raise ValueError(f"WAV missing fmt/data chunk: {path}")
    audio_format, channels, sample_rate, _, _, bits = fmt
    if audio_format == _WAVE_FORMAT_EXTENSIBLE and len(fmt_body) >= 26:
        # the true format is the first 2 bytes of the SubFormat GUID
        (audio_format,) = struct.unpack_from("<H", fmt_body, 24)

    if audio_format == _WAVE_FORMAT_PCM:
        if bits == 16:
            x = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
        elif bits == 32:
            x = np.frombuffer(raw, dtype="<i4").astype(np.float32) / 2147483648.0
        elif bits == 8:
            x = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
        elif bits == 24:
            b = np.frombuffer(raw, dtype=np.uint8)
            b = b[: (len(b) // 3) * 3].reshape(-1, 3)
            val = b[:, 0].astype(np.int32) | (b[:, 1].astype(np.int32) << 8) | (b[:, 2].astype(np.int32) << 16)
            val = np.where(val >= 1 << 23, val - (1 << 24), val)
            x = val.astype(np.float32) / float(1 << 23)
        else:
            raise ValueError(f"unsupported PCM bit depth {bits}")
    elif audio_format == _WAVE_FORMAT_IEEE_FLOAT:
        if bits == 32:
            x = np.frombuffer(raw, dtype="<f4").astype(np.float32)
        elif bits == 64:
            x = np.frombuffer(raw, dtype="<f8").astype(np.float32)
        else:
            raise ValueError(f"unsupported float bit depth {bits}")
    else:
        raise ValueError(f"unsupported WAVE format tag 0x{audio_format:04x}")

    channels = max(1, channels)
    usable = (len(x) // channels) * channels
    return x[:usable].reshape(-1, channels), int(sample_rate)


def load_wav(path: str | os.PathLike, mono: bool = True) -> tuple[np.ndarray, int]:
    """Load a WAV as float32; downmix to mono by the channel mean."""
    x, sr = read_wav(path)
    if mono and x.shape[1] > 1:
        x = x.mean(axis=1)
    elif mono:
        x = x[:, 0]
    return np.ascontiguousarray(x, dtype=np.float32), sr


def peak_normalize(x: np.ndarray, peak: float = 0.95) -> np.ndarray:
    """Scale so max |x| == peak (reference: audio.py:24-26)."""
    m = float(np.max(np.abs(x))) if x.size else 0.0
    if m <= 1e-9:
        return x
    return (x * (peak / m)).astype(np.float32)


def decode_for_analysis(input_path: str | os.PathLike, analysis_sr: int) -> tuple[np.ndarray, int, tuple[np.ndarray, int]]:
    """Decode a WAV upload to mono at ``analysis_sr`` with one resample from
    the native rate → (audio, analysis_sr, (native_audio, native_sr))."""
    x, sr = load_wav(input_path, mono=True)
    y = resample_poly_host(x, sr, analysis_sr) if sr != analysis_sr else x
    return y, analysis_sr, (x, sr)

