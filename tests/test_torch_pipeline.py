"""The port's pipeline against the JAX package's: the host tail on the same
features, the slice as a whole, the CLI and the failure paths.

Tail parity: for a 5 s crop of each of the six held-out clips the port's CPU
fused features (``run_analysis``, ``ENABLE_DEMUCS=False``, as
tests/test_torch_fused.py computes them) and the same native-rate audio go
through the JAX ``_pipeline_tail`` and the port's, in guitar and
accompaniment mode, with ``stem_source`` "guitar" and "mix". Every artifact
must be equal: JSON parsed, ``.csv``/``.musicxml``/``.mid``/``.ly``/``.pdf``
as bytes, ``profile.json`` (times) by keys; the returned ``JobResult`` as
JSON.

The slice as a whole: the port's ``run_pipeline(device="cpu")`` and the JAX
``run_pipeline`` on the crops of ``heldout_strum_band`` (chordal, strum path)
and ``heldout_picked_melody`` (melodic), ``ENABLE_DEMUCS=False``
(separation parity is tests/test_torch_separation.py's). ``chords.json``,
``beat_times.json`` field by field, the chord labels and bounds, the key and
time signature and the content segments' types are equal exactly;
``note_events.csv`` row for row, its amplitude column within one f16 ulp
(the mean of f16 frame posteriors that agree within one ulp between the
packages; no note opens, ends or flips differently on these crops). The
chord confidences and the key's score are float32 posteriors of the fused
analysis (XLA against torch): rtol 1e-5.
Decodes: the JAX ``load_wav`` decodes with the C++ library of ``native/``
when it is built, and its resampler then differs from the port's numpy
resampler by up to 6e-8 on the 44.1 kHz clips (equal on the 22.05 kHz
ones); the channel mean is equal either way. The test checks that, then
feeds the JAX pipeline the port's resampler, so both analyse the same
samples.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from audiotabs_tpu_torch.config import Settings

HELDOUT_DIR = Path(__file__).parent / "data" / "heldout"
HELDOUT = sorted(p.name for p in HELDOUT_DIR.glob("*.wav"))
SR = 22050
CROP = Settings(ENABLE_DEMUCS=False, PAD_SECONDS_BUCKET=6.0)
# the artifact set of tests/test_pipeline.py, and the JSON artifacts of the tail
ARTIFACTS = {"result.musicxml", "transcription.mid", "note_events.csv", "beat_times.json", "chords.json", "profile.json",
             "score.ly", "score.pdf", "tab_positions.json", "threshold_calibration.json"}


@pytest.fixture(scope="module", autouse=True)
def torch_threads():
    """Two intra-op threads, as in tests/test_torch_fused.py (the suite runs
    files in parallel workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def jax_env(monkeypatch):
    """Set the JAX package's settings through the environment; restored after the test."""
    from audiotabs_tpu.config import reload_settings

    def set_env(**env):
        for k, v in env.items():
            monkeypatch.setenv(k, str(v))
        reload_settings()

    yield set_env
    monkeypatch.undo()
    reload_settings()


def _crop(name: str, dest: Path) -> Path:
    from audiotabs_tpu.io.wav import read_wav, write_wav

    x, sr = read_wav(HELDOUT_DIR / name)
    path = dest / f"{Path(name).stem}_crop.wav"
    write_wav(path, x[3 * sr : 8 * sr], sr)
    return path


@pytest.fixture(scope="module", params=HELDOUT)
def features(request, tmp_path_factory):
    """The port's CPU fused features of one crop, and its decoded audio."""
    from audiotabs_tpu_torch.io.wav import decode_for_analysis, peak_normalize
    from audiotabs_tpu_torch.runtime.pipeline import run_analysis

    path = _crop(request.param, tmp_path_factory.mktemp("crop"))
    feats, _beats, info = run_analysis(path, device="cpu", settings=CROP)
    assert info == {"stem_source": "mix", "errors": []}
    y, sr, (x_nat, sr_nat) = decode_for_analysis(path, SR)
    return feats, peak_normalize(y), (peak_normalize(x_nat), sr_nat)


def _read(path: Path):
    return json.loads(path.read_text()) if path.suffix == ".json" else path.read_bytes()


def _assert_same_artifacts(ref_dir: Path, got_dir: Path):
    names = sorted(p.name for p in ref_dir.iterdir())
    assert sorted(p.name for p in got_dir.iterdir()) == names
    for name in names:
        ref, got = _read(ref_dir / name), _read(got_dir / name)
        if name == "profile.json":
            assert list(got) == list(ref)
        else:
            assert got == ref, name


@pytest.mark.parametrize("mode", ["guitar", "accompaniment"])
@pytest.mark.parametrize("stem_source", ["guitar", "mix"])
def test_tail_matches_jax_on_the_same_features(features, stem_source, mode, tmp_path, jax_env):
    from audiotabs_tpu.runtime.pipeline import StageTimer as JaxTimer
    from audiotabs_tpu.runtime.pipeline import _pipeline_tail as jax_tail
    from audiotabs_tpu_torch.runtime.pipeline import StageTimer, _pipeline_tail

    feats, y, native = features
    true_len = len(y)
    y_harm = np.asarray(feats["y_harm"], dtype=np.float32)[:true_len]
    common = dict(feats=feats, y_harm=y_harm, true_len=true_len, sr=SR, job_id="job", stem_source=stem_source,
                  beat_act_from_feats=True, y_native=native)
    jax_env(TRANSCRIPTION_MODE=mode)
    ref = jax_tail(**common, y=y, work=tmp_path / "jax_work", out=tmp_path / "jax", timer=JaxTimer(), errors=[], beat_source=None)
    got = _pipeline_tail(**common, out=tmp_path / "port", timer=StageTimer(), errors=[], settings=Settings(TRANSCRIPTION_MODE=mode))
    assert ref.transcription_error is None and ref.score is not None
    assert json.loads(got.to_json()) == json.loads(ref.model_dump_json())
    names = {p.name for p in (tmp_path / "port").iterdir()}
    assert ARTIFACTS <= names and ("strum_onsets.json" in names or mode == "guitar")
    _assert_same_artifacts(tmp_path / "jax", tmp_path / "port")


@pytest.mark.parametrize("clip", ["heldout_strum_band.wav", "heldout_picked_melody.wav"])
def test_run_pipeline_matches_jax(clip, tmp_path, jax_env, monkeypatch):
    import audiotabs_tpu.io.resample as jax_resample
    from audiotabs_tpu.io.wav import decode_for_analysis as jax_decode
    from audiotabs_tpu.runtime.pipeline import run_pipeline as jax_run
    from audiotabs_tpu_torch.io.resample import resample_poly_host
    from audiotabs_tpu_torch.io.wav import decode_for_analysis
    from audiotabs_tpu_torch.runtime.pipeline import run_pipeline

    path = _crop(clip, tmp_path)
    # the two decodes first: the JAX one may take the native library's resampler
    y_ref, _, writer, (x_ref, sr_ref) = jax_decode(path, tmp_path / "jax_mono.wav", SR)
    writer.join()
    y, _, (x, sr_nat) = decode_for_analysis(path, SR)
    assert sr_ref == sr_nat and np.array_equal(x_ref, x)
    assert np.abs(y_ref - y).max() <= 6e-8
    # from here on the JAX pipeline resamples with the port's resampler
    monkeypatch.setattr(jax_resample, "resample_poly_host", resample_poly_host)

    jax_env(ENABLE_DEMUCS="False", PAD_SECONDS_BUCKET="6")
    ref = jax_run(tmp_path / "jax" / "job", path)
    got = run_pipeline(tmp_path / "port" / "job", path, device="cpu", settings=CROP)
    ref_out, got_out = tmp_path / "jax" / "job" / "out", tmp_path / "port" / "job" / "out"
    assert ref.transcription_error is None and got.transcription_error is None

    ref_bt, got_bt = _read(ref_out / "beat_times.json"), _read(got_out / "beat_times.json")
    assert list(got_bt) == list(ref_bt)
    for field in ref_bt:
        assert got_bt[field] == ref_bt[field], field
    # chord labels and bounds exactly; each confidence is a float32 CRF
    # posterior that the two packages compute with different libraries
    ref_ch, got_ch = _read(ref_out / "chords.json"), _read(got_out / "chords.json")
    assert [(c["start"], c["end"], c["label"]) for c in got_ch] == [(c["start"], c["end"], c["label"]) for c in ref_ch]
    np.testing.assert_allclose([c["confidence"] for c in got_ch], [c["confidence"] for c in ref_ch], rtol=1e-5)
    ref_key, got_key = ref.key_signature.model_dump(), got.key_signature.to_dict()
    np.testing.assert_allclose(got_key.pop("score"), ref_key.pop("score"), rtol=1e-5)
    assert (got_key, got.time_signature) == (ref_key, ref.time_signature)
    assert [s["type"] for s in _read(got_out / "content_segments.json")] == [s["type"] for s in _read(ref_out / "content_segments.json")]
    # note events row for row: no note opens, ends or flips differently; the
    # amplitude is a mean of f16 frame posteriors that agree within one f16 ulp
    ref_rows = [r.split(",") for r in (ref_out / "note_events.csv").read_text().splitlines()]
    got_rows = [r.split(",") for r in (got_out / "note_events.csv").read_text().splitlines()]
    assert len(ref_rows) > 5 and len(got_rows) == len(ref_rows) and got_rows[0] == ref_rows[0]
    assert [r[:4] for r in got_rows] == [r[:4] for r in ref_rows]
    np.testing.assert_allclose([float(r[4]) for r in got_rows[1:]], [float(r[4]) for r in ref_rows[1:]], rtol=2**-10, atol=2**-14)
    for wav in ("audio_mono_44k.wav", "audio_harmonic.wav"):
        assert (tmp_path / "port" / "job" / "work" / wav).exists()
    assert (tmp_path / "port" / "job" / "work" / "audio_mono_44k.wav").read_bytes() == (tmp_path / "jax" / "job" / "work" / "audio_mono_44k.wav").read_bytes()


def test_cli_writes_result_and_artifacts(tmp_path, monkeypatch, capsys):
    from audiotabs_tpu_torch.runtime.cli import main

    for k, v in (("ENABLE_DEMUCS", "False"), ("PAD_SECONDS_BUCKET", "6")):
        monkeypatch.setenv(k, v)
    path = _crop("heldout_strum_band.wav", tmp_path)
    job = tmp_path / "jobs" / "clijob"
    assert main([str(path), "--job-dir", str(job), "--device", "cpu", "--mode", "accompaniment", "--keep"]) == 0
    out = job / "out"
    result = json.loads((out / "result.json").read_text())
    assert result["job_id"] == "clijob" and result["transcription_backend"] == "accompaniment+chords_viterbi"
    assert result["transcription_error"] is None and result["key_signature"] and result["chords"] and result["score"]["measures"]
    assert ARTIFACTS | {"result.json", "strum_onsets.json", "chosen_shapes.json"} <= {p.name for p in out.iterdir()}
    bt = json.loads((out / "beat_times.json").read_text())
    assert (bt["transcription_mode"], bt["beat_source"], bt["stem_source"], bt["demucs_error"]) == ("accompaniment", "mix", "mix", None)
    assert (out / "score.pdf").read_bytes().startswith(b"%PDF")
    assert {p.name for p in (job / "work").iterdir()} == {"audio_mono_44k.wav", "audio_harmonic.wav"}
    assert (job / "input" / "upload.wav").exists()
    assert "backend: accompaniment+chords_viterbi" in capsys.readouterr().out


def test_failed_analysis_records_each_stage_and_writes_the_artifacts(tmp_path, monkeypatch):
    from audiotabs_tpu_torch.runtime import pipeline

    def fail(*args, **kwargs):
        raise RuntimeError("forced")

    monkeypatch.setattr(pipeline, "fused_analysis", fail)
    path = _crop("heldout_strum_band.wav", tmp_path)
    result = pipeline.run_pipeline(tmp_path / "job", path, device="cpu", settings=CROP)
    errors = result.transcription_error.split("; ")
    assert [e.split(":")[0] for e in errors] == ["analysis", "harmonic", "beats", "calibration", "transcription", "chords", "mode(guitar)"]
    assert errors[0] == "analysis: forced" and all("item 14" in e for e in errors[1:])
    out = tmp_path / "job" / "out"
    assert json.loads((out / "beat_times.json").read_text())["errors"] == errors
    assert {"beat_times.json", "chords.json", "note_events.csv", "profile.json", "score.ly", "score.pdf"} <= {p.name for p in out.iterdir()}
    assert (result.tempo_bpm, result.time_signature, result.chords) == (120.0, "4/4", [])


def test_notes_mode_is_not_ported(tmp_path):
    from audiotabs_tpu_torch.runtime.pipeline import run_pipeline, run_pipeline_from_features

    notes = dataclasses.replace(CROP, TRANSCRIPTION_MODE="notes")
    with pytest.raises(NotImplementedError, match="item 14"):
        run_pipeline(tmp_path / "job", HELDOUT_DIR / HELDOUT[0], device="cpu", settings=notes)
    with pytest.raises(NotImplementedError, match="item 14"):
        run_pipeline_from_features({}, 1, SR, tmp_path / "job", settings=notes)
    assert not (tmp_path / "job").exists()


def test_run_pipeline_from_features_matches_jax(features, tmp_path, jax_env):
    """The batch runner's tail: no native-rate audio, so strums are read off the fused 22.05 kHz envelope."""
    from audiotabs_tpu.runtime.pipeline import run_pipeline_from_features as jax_from_features
    from audiotabs_tpu_torch.runtime.pipeline import run_pipeline_from_features

    feats, y, _native = features
    jax_env()
    ref = jax_from_features(feats, len(y), SR, tmp_path / "jax" / "jobs" / "b1", stem_source="mix")
    got = run_pipeline_from_features(feats, len(y), SR, tmp_path / "port" / "jobs" / "b1", stem_source="mix", settings=Settings())
    assert got.transcription_error is None
    assert json.loads(got.to_json()) == json.loads(ref.model_dump_json())
    _assert_same_artifacts(tmp_path / "jax" / "jobs" / "b1" / "out", tmp_path / "port" / "jobs" / "b1" / "out")
    assert (tmp_path / "port" / "jobs" / "b1" / "work" / "audio_harmonic.wav").read_bytes() == (tmp_path / "jax" / "jobs" / "b1" / "work" / "audio_harmonic.wav").read_bytes()
