"""The port's decoders against the JAX package's, on the CPU.

The port builds ``native/audiotabs_native.cpp`` with the JAX package's flags
(``g++ -O3 -shared -fPIC``) into ``build/``, so its WAV decoder and its
resampler are the same code as the JAX ones: every comparison here is exact
(``np.array_equal``, and the written WAVs byte for byte; this held also
against ``native/build.sh``'s ``-march=native`` build of the JAX package's
library, since the resampler accumulates in double and rounds to float32),
on the six
held-out WAVs, on an MP3 encoded with the system libmp3lame (the fixture
pattern of tests/test_mp3.py) and on a FLAC written here (verbatim
subframes) through the FFmpeg-library shim. ``AUDIOTABS_DISABLE_NATIVE``
sends both packages to the Python codec and scipy's resampler, and a file
no decoder takes raises the JAX package's error text.
"""

from __future__ import annotations

import shutil
import struct
from pathlib import Path

import numpy as np
import pytest

from audiotabs_tpu_torch.config import Settings
from test_torch_fused import torch_threads  # noqa: F401 (an autouse fixture: two intra-op threads)

HELDOUT_DIR = Path(__file__).parent / "data" / "heldout"
HELDOUT = sorted(p.name for p in HELDOUT_DIR.glob("*.wav"))
SR = 22050


def _crop(name: str, seconds: float = 5.0) -> tuple[np.ndarray, int]:
    from audiotabs_tpu.io.wav import read_wav

    x, sr = read_wav(HELDOUT_DIR / name)
    return np.ascontiguousarray(x.mean(axis=1)[3 * sr : 3 * sr + int(seconds * sr)]), sr


def _crc8(data: bytes) -> int:
    crc = 0
    for b in data:
        crc ^= b
        for _ in range(8):
            crc = ((crc << 1) ^ 0x07) & 0xFF if crc & 0x80 else (crc << 1) & 0xFF
    return crc


def _crc16(data: bytes) -> int:
    crc = 0
    for b in data:
        crc ^= b << 8
        for _ in range(8):
            crc = ((crc << 1) ^ 0x8005) & 0xFFFF if crc & 0x8000 else (crc << 1) & 0xFFFF
    return crc


def _write_flac(path: Path, pcm: np.ndarray, sr: int, block: int = 4096) -> None:
    """Mono 16-bit FLAC with verbatim subframes (test fixture only)."""
    s16 = np.clip(np.round(pcm * 32767.0), -32768, 32767).astype(">i2")
    info = struct.pack(">HH", block, block) + b"\0" * 6
    info += ((sr << 44) | (0 << 41) | (15 << 36) | len(s16)).to_bytes(8, "big") + b"\0" * 16
    out = bytearray(b"fLaC" + bytes([0x80]) + len(info).to_bytes(3, "big") + info)
    for n, a in enumerate(range(0, len(s16), block)):
        chunk = s16[a : a + block]
        assert n < 128  # one-byte frame number
        hdr = bytes([0xFF, 0xF8, 0x70, 0x08, n]) + struct.pack(">H", len(chunk) - 1)
        frame = hdr + bytes([_crc8(hdr), 0x02]) + chunk.tobytes()
        out += frame + struct.pack(">H", _crc16(frame))
    path.write_bytes(bytes(out))


@pytest.fixture(scope="module")
def uploads(tmp_path_factory):
    """A 5 s crop of a held-out clip as MP3 (libmp3lame) and as FLAC."""
    from test_mp3 import _encode_mp3

    tmp = tmp_path_factory.mktemp("uploads")
    pcm, sr = _crop("heldout_strum_band.wav")
    pcm = (0.9 * pcm / np.abs(pcm).max()).astype(np.float32)
    mp3 = tmp / "crop.mp3"
    if not _encode_mp3(mp3, pcm, sr):
        mp3 = None
    flac = tmp / "crop.flac"
    _write_flac(flac, pcm, sr)
    return {"mp3": mp3, "flac": flac, "pcm": pcm, "sr": sr}


def test_native_library_builds_into_build_and_matches_the_jax_resampler():
    from audiotabs_tpu.io.native import resample_native as jax_resample
    from audiotabs_tpu_torch._build import BUILD_DIR
    from audiotabs_tpu_torch.io import native

    lib = native.get_lib()
    assert lib is not None and Path(lib._name).parent == BUILD_DIR and "native" not in Path(lib._name).parent.parts
    x = np.random.default_rng(0).standard_normal(20000).astype(np.float32)
    for sr_in, sr_out in [(44100, 22050), (48000, 22050), (22050, 44100), (8000, 22050)]:
        ref = jax_resample(x, sr_in, sr_out)
        assert ref is not None and np.array_equal(native.resample_native(x, sr_in, sr_out), ref)


@pytest.mark.parametrize("clip", HELDOUT)
def test_heldout_wav_decodes_match_jax(clip, tmp_path):
    from audiotabs_tpu.io import native as jax_native
    from audiotabs_tpu.io import wav as jax_wav
    from audiotabs_tpu_torch.io import native, wav

    path = HELDOUT_DIR / clip
    for mono in (True, False):
        (got, sr), (ref, sr_ref) = native.read_wav_native(path, mono=mono), jax_native.read_wav_native(path, mono=mono)
        assert sr == sr_ref and np.array_equal(got, ref)
    (got, sr), (ref, sr_ref) = wav.load_wav(path), jax_wav.load_wav(path)
    assert sr == sr_ref and np.array_equal(got, ref)
    (got, sr), (ref, sr_ref) = wav.decode_mono(path), jax_wav.decode_mono(path)
    assert sr == sr_ref and np.array_equal(got, ref)

    y, sr_y, (x, sr_x) = wav.decode_for_analysis(path, SR)
    y_ref, sr_y_ref, writer, (x_ref, sr_x_ref) = jax_wav.decode_for_analysis(path, tmp_path / "jax.wav", SR)
    writer.join()
    assert (sr_y, sr_x) == (sr_y_ref, sr_x_ref) and np.array_equal(y, y_ref) and np.array_equal(x, x_ref)

    got44, _ = wav.decode_to_mono_44k(path, tmp_path / "port44.wav")
    ref44, _ = jax_wav.decode_to_mono_44k(path, tmp_path / "jax44.wav")
    assert np.array_equal(got44, ref44)
    assert (tmp_path / "port44.wav").read_bytes() == (tmp_path / "jax44.wav").read_bytes() == (tmp_path / "jax.wav").read_bytes()


def test_resample_poly_host_matches_jax():
    from audiotabs_tpu.io.resample import resample_poly_host as jax_resample
    from audiotabs_tpu_torch.io.resample import resample_poly_host

    x = np.random.default_rng(1).standard_normal(30000).astype(np.float32)
    for sr_in, sr_out in [(44100, 22050), (48000, 22050), (22050, 22050), (16000, 44100)]:
        got, ref = resample_poly_host(x, sr_in, sr_out), jax_resample(x, sr_in, sr_out)
        assert got.dtype == ref.dtype == np.float32 and np.array_equal(got, ref)


def test_disable_native_takes_the_python_codec_and_scipy(monkeypatch, tmp_path):
    """AUDIOTABS_DISABLE_NATIVE, the JAX package's knob: no native library;
    WAVs through the Python codec and resampling through scipy, in both
    packages (the JAX one reads the knob once, so its cached library is
    dropped here)."""
    import audiotabs_tpu.io.native as jax_native
    from audiotabs_tpu.io.resample import resample_poly_host as jax_resample
    from audiotabs_tpu.io.wav import load_wav as jax_load
    from audiotabs_tpu_torch.io import native
    from audiotabs_tpu_torch.io.resample import resample_poly_host
    from audiotabs_tpu_torch.io.wav import decode_for_analysis, load_wav, read_wav

    monkeypatch.setenv("AUDIOTABS_DISABLE_NATIVE", "1")
    monkeypatch.setattr(jax_native, "_lib", None)
    monkeypatch.setattr(jax_native, "_tried", True)
    assert native.get_lib() is None and native.resample_native(np.zeros(10, np.float32), 44100, 22050) is None
    path = HELDOUT_DIR / "heldout_strum_band.wav"
    x, sr = load_wav(path)
    raw, _ = read_wav(path)
    assert np.array_equal(x, raw.mean(axis=1)) and np.array_equal(x, jax_load(path)[0])
    from scipy.signal import resample_poly

    for sr_in, sr_out in [(44100, 22050), (48000, 22050)]:
        got = resample_poly_host(x, sr_in, sr_out)
        assert np.array_equal(got, resample_poly(x.astype(np.float64), *{(44100, 22050): (1, 2), (48000, 22050): (147, 320)}[(sr_in, sr_out)]).astype(np.float32))
        assert np.array_equal(got, jax_resample(x, sr_in, sr_out))
    y, _, (native_x, sr_nat) = decode_for_analysis(path, SR)
    assert sr_nat == sr and np.array_equal(native_x, x)
    monkeypatch.delenv("AUDIOTABS_DISABLE_NATIVE")
    assert native.get_lib() is not None


def test_mp3_upload_decodes_as_jax(uploads, tmp_path):
    from audiotabs_tpu.io import mp3 as jax_mp3
    from audiotabs_tpu.io import wav as jax_wav
    from audiotabs_tpu_torch.io import mp3, wav

    path = uploads["mp3"]
    if path is None or not mp3.mp3_available():
        pytest.skip("libmp3lame or libmpg123 is absent")
    assert mp3.looks_like_mp3(path) and jax_mp3.looks_like_mp3(path)
    for mono in (True, False):
        (got, sr), (ref, sr_ref) = mp3.decode_mp3(path, mono=mono), jax_mp3.decode_mp3(path, mono=mono)
        assert sr == sr_ref == uploads["sr"] and np.array_equal(got, ref)
    (got, sr), (ref, _) = wav.decode_mono(path), jax_wav.decode_mono(path)
    assert np.array_equal(got, ref) and got.dtype == np.float32
    # the decoded audio is the crop (lame's encoder delay aside)
    n = uploads["sr"]
    lag = int(np.argmax(np.correlate(got[: 2 * n], uploads["pcm"][:n], mode="valid")))
    assert np.corrcoef(got[lag : lag + n], uploads["pcm"][:n])[0, 1] > 0.97
    y, _, (x, sr_x) = wav.decode_for_analysis(path, SR)
    y_ref, _, writer, (x_ref, sr_x_ref) = jax_wav.decode_for_analysis(path, tmp_path / "jax.wav", SR)
    writer.join()
    assert sr_x == sr_x_ref and np.array_equal(y, y_ref) and np.array_equal(x, x_ref)
    got44, _ = wav.decode_to_mono_44k(path, tmp_path / "port44.wav")
    ref44, _ = jax_wav.decode_to_mono_44k(path, tmp_path / "jax44.wav")
    assert np.array_equal(got44, ref44) and (tmp_path / "port44.wav").read_bytes() == (tmp_path / "jax44.wav").read_bytes()


@pytest.mark.parametrize("kind", ["mp3", "flac"])
def test_av_shim_decodes_as_jax(uploads, kind, tmp_path):
    """The FFmpeg-library shim, built from native/audiotabs_decode.c into build/."""
    from audiotabs_tpu.io import avdecode as jax_av
    from audiotabs_tpu.io import wav as jax_wav
    from audiotabs_tpu_torch._build import BUILD_DIR
    from audiotabs_tpu_torch.io import avdecode, wav

    if not avdecode.headers_present():
        assert not avdecode.av_available()
        pytest.skip("the libavformat headers are absent: the shim is reported absent, as in the JAX package")
    if not jax_av.av_available():
        pytest.skip("the JAX package's shim is not built")
    assert Path(avdecode._load_lib()._name).parent == BUILD_DIR
    path = uploads[kind]
    if path is None:
        pytest.skip("libmp3lame is absent")
    (got, sr), (ref, sr_ref) = avdecode.decode_any(path), jax_av.decode_any(path)
    assert sr == sr_ref == uploads["sr"] and np.array_equal(got, ref)
    if kind == "flac":
        # lossless: the 16-bit samples exactly; and the upload route (not a
        # WAV, not an MP3) takes the shim in both packages
        s16 = np.clip(np.round(uploads["pcm"] * 32767.0), -32768, 32767)
        assert np.array_equal(got, (s16 / 32768.0).astype(np.float32))
        (mono, _), (mono_ref, _) = wav.decode_mono(path), jax_wav.decode_mono(path)
        assert np.array_equal(mono, got) and np.array_equal(mono_ref, got)
        y, _, (x, _) = wav.decode_for_analysis(path, SR)
        assert np.array_equal(x, got) and len(y) == len(got) * SR // uploads["sr"]
    with pytest.raises(RuntimeError, match="decode failed"):
        avdecode.decode_any(tmp_path / "missing.ogg")


def test_no_decoder_raises_the_jax_error(monkeypatch, tmp_path):
    from audiotabs_tpu.io import wav as jax_wav
    from audiotabs_tpu_torch.io import wav

    path = tmp_path / "noise.xyz"
    path.write_bytes(np.random.default_rng(2).integers(1, 200, 4096, dtype=np.uint8).tobytes())
    for module in (wav, jax_wav):
        monkeypatch.setattr(module.shutil, "which", lambda _name: None)
    with pytest.raises(RuntimeError) as ref:
        jax_wav.decode_to_mono_44k(path, tmp_path / "jax.wav")
    with pytest.raises(RuntimeError) as got:
        wav.decode_to_mono_44k(path, tmp_path / "port.wav")
    assert str(got.value) == str(ref.value) == "cannot decode noise.xyz: not a WAV and no ffmpeg binary available"
    assert wav.decode_mono(path) is None and jax_wav.decode_mono(path) is None
    with pytest.raises(RuntimeError, match="no ffmpeg binary"):
        wav.decode_for_analysis(path, SR)


def test_mp3_job_runs_the_pipeline(uploads, tmp_path):
    """An MP3 upload goes through the port's run_pipeline (CPU, mix analysed)
    as its decoded WAV does: the same beats, chords and key."""
    from audiotabs_tpu_torch.io import mp3
    from audiotabs_tpu_torch.io.wav import decode_mono, write_wav
    from audiotabs_tpu_torch.runtime.pipeline import run_pipeline

    if uploads["mp3"] is None or not mp3.mp3_available():
        pytest.skip("libmp3lame or libmpg123 is absent")
    crop = Settings(ENABLE_DEMUCS=False, PAD_SECONDS_BUCKET=6.0)
    job = tmp_path / "jobs" / "mp3job"
    (job / "input").mkdir(parents=True)
    upload = job / "input" / "upload.mp3"
    shutil.copy(uploads["mp3"], upload)
    got = run_pipeline(job, upload, device="cpu", settings=crop)
    x, sr = decode_mono(uploads["mp3"])
    write_wav(tmp_path / "decoded.wav", x, sr)
    ref = run_pipeline(tmp_path / "jobs" / "wavjob", tmp_path / "decoded.wav", device="cpu", settings=crop)
    assert got.transcription_error is None and ref.transcription_error is None
    assert (got.tempo_bpm, got.time_signature, got.key_signature, [c.label for c in got.chords]) == (
        ref.tempo_bpm, ref.time_signature, ref.key_signature, [c.label for c in ref.chords])
    assert (job / "work" / "audio_mono_44k.wav").exists() and (job / "out" / "note_events.csv").read_bytes() == (
        tmp_path / "jobs" / "wavjob" / "out" / "note_events.csv").read_bytes()
