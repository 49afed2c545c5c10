"""Host-side audio decoding and WAV writing (numpy).

Counterpart of audiotabs_tpu/io/wav.py: the RIFF/WAVE codec (``read_wav``,
``write_wav``), ``load_wav`` (the native C++ decoder of io/native.py first),
``peak_normalize``, and the decoders of any upload with the JAX package's
routing: WAV by its suffix or its header, then MP3 through libmpg123
(io/mp3.py), then any container through the FFmpeg-library shim
(io/avdecode.py), then an ``ffmpeg`` binary (``decode_to_mono_44k``), and an
error when none is present. ``write_artifact_async`` is the thread that
writes the 44.1 kHz mono work artifact while the card runs (the JAX
``decode_for_analysis`` starts it itself).
"""

from __future__ import annotations

import os
import shutil
import struct
import subprocess
import tempfile
import threading
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


def write_wav(path: str | os.PathLike, x: np.ndarray, sr: int, *, pcm16: bool = False) -> None:
    """Write float32 (or int16) audio as a WAV. x is [samples] or [samples, ch]."""
    x = np.asarray(x)
    if x.ndim == 1:
        x = x[:, None]
    channels = x.shape[1]
    if pcm16:
        body = np.clip(np.round(x * 32767.0), -32768, 32767).astype("<i2").tobytes()
        fmt_tag, bits = _WAVE_FORMAT_PCM, 16
    else:
        body = x.astype("<f4").tobytes()
        fmt_tag, bits = _WAVE_FORMAT_IEEE_FLOAT, 32
    byte_rate = sr * channels * bits // 8
    block_align = channels * bits // 8
    hdr = b"RIFF" + struct.pack("<I", 36 + len(body)) + b"WAVE"
    hdr += b"fmt " + struct.pack("<IHHIIHH", 16, fmt_tag, channels, sr, byte_rate, block_align, bits)
    hdr += b"data" + struct.pack("<I", len(body))
    Path(path).write_bytes(hdr + body)


def load_wav(path: str | os.PathLike, mono: bool = True) -> tuple[np.ndarray, int]:
    """Load a WAV as float32; downmix to mono by the channel mean. Uses the
    native decoder when it is built, else the pure-Python codec."""
    try:
        from .native import read_wav_native

        native = read_wav_native(path, mono=mono)
        if native is not None:
            return native
    except Exception:
        pass
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


def decode_mono(input_path: str | os.PathLike) -> tuple[np.ndarray, int] | None:
    """Decode a WAV/MP3/FFmpeg-supported container to mono at its native
    rate, or None when no in-process decoder recognizes the bytes."""
    input_path = Path(input_path)
    if input_path.suffix.lower() in (".wav", ".wave") or _looks_like_wav(input_path):
        return load_wav(input_path, mono=True)

    from .mp3 import decode_mp3, looks_like_mp3, mp3_available

    if (input_path.suffix.lower() == ".mp3" or looks_like_mp3(input_path)) and mp3_available():
        x, sr = decode_mp3(input_path, mono=True)
        return x.astype(np.float32), sr

    from .avdecode import av_available, decode_any

    if av_available():
        try:
            x, sr = decode_any(input_path)
        except RuntimeError:
            return None
        if x is not None and x.size:
            return x.astype(np.float32), sr
    return None


def decode_for_analysis(input_path: str | os.PathLike, analysis_sr: int) -> tuple[np.ndarray, int, tuple[np.ndarray, int]]:
    """Decode any upload to mono at ``analysis_sr`` with one resample from the
    native rate → (audio, analysis_sr, (native_audio, native_sr)).

    The native-rate audio is returned for the full-band detectors of the
    host tail (strum onsets), as in the JAX package. When no in-process
    decoder recognizes the file, the ``ffmpeg`` binary decodes it to mono
    44.1 kHz (``decode_to_mono_44k``), and that is the native audio."""
    decoded = decode_mono(input_path)
    if decoded is None:
        with tempfile.TemporaryDirectory() as tmp:
            x, sr = decode_to_mono_44k(input_path, Path(tmp) / "mono_44k.wav")
    else:
        x, sr = decoded
    y = resample_poly_host(x, sr, analysis_sr) if sr != analysis_sr else x
    return y, analysis_sr, (x, sr)


def decode_to_mono_44k(input_path: str | os.PathLike, out_path: str | os.PathLike) -> tuple[np.ndarray, int]:
    """Decode any input to a mono 44.1 kHz WAV at ``out_path``, returning the
    audio: WAV, MP3 and the FFmpeg shim in process, else the ``ffmpeg``
    binary; raises when none of them can decode it."""
    input_path = Path(input_path)
    target_sr = 44100
    if input_path.suffix.lower() in (".wav", ".wave") or _looks_like_wav(input_path):
        x, sr = load_wav(input_path, mono=True)
        if sr != target_sr:
            x = resample_poly_host(x, sr, target_sr)
        write_wav(out_path, x, target_sr)
        return x, target_sr

    from .mp3 import decode_mp3, looks_like_mp3, mp3_available

    if (input_path.suffix.lower() == ".mp3" or looks_like_mp3(input_path)) and mp3_available():
        x, sr = decode_mp3(input_path, mono=True)
        if sr != target_sr:
            x = resample_poly_host(x, sr, target_sr)
        x = x.astype(np.float32)
        write_wav(out_path, x, target_sr)
        return x, target_sr

    # any other container (ogg/flac/m4a/...) through the FFmpeg-library shim
    from .avdecode import av_available, decode_any

    if av_available():
        try:
            x, sr = decode_any(input_path)
        except RuntimeError:
            x = None
        if x is not None and x.size:
            if sr != target_sr:
                x = resample_poly_host(x, sr, target_sr)
            x = x.astype(np.float32)
            write_wav(out_path, x, target_sr)
            return x, target_sr

    ffmpeg = shutil.which("ffmpeg")
    if ffmpeg is None:
        raise RuntimeError(f"cannot decode {input_path.name}: not a WAV and no ffmpeg binary available")
    subprocess.run(
        [ffmpeg, "-y", "-i", str(input_path), "-ac", "1", "-ar", str(target_sr), str(out_path)],
        check=True,
        capture_output=True,
    )
    return load_wav(out_path, mono=True)


def _looks_like_wav(path: Path) -> bool:
    try:
        with open(path, "rb") as f:
            hdr = f.read(12)
        return hdr[:4] == b"RIFF" and hdr[8:12] == b"WAVE"
    except OSError:
        return False


def write_artifact_async(x: np.ndarray, sr: int, out_path: str | os.PathLike) -> threading.Thread:
    """Resample mono ``x`` to 44.1 kHz and write it to ``out_path`` on a
    daemon thread, so the resample and the disk write overlap the device
    work. Join the thread before relying on ``out_path``; a failure is left
    in its ``error`` attribute."""

    def _write_artifact():
        try:
            write_wav(out_path, resample_poly_host(x, sr, 44100) if sr != 44100 else x, 44100)
        except Exception as exc:  # surfaced by the caller after join()
            t.error = exc

    t = threading.Thread(target=_write_artifact, daemon=True)
    t.error = None  # type: ignore[attr-defined]
    t.start()
    return t
