"""The port's pipeline against the JAX package's: the host tail on the same
features, the slice as a whole, the CLI and the failure paths.

Tail parity: for a 5 s crop of each of the six held-out clips the port's CPU
fused features (``run_analysis``, ``ENABLE_DEMUCS=False``, as
tests/test_torch_fused.py computes them) and the same native-rate audio go
through the JAX ``_pipeline_tail`` and the port's, in guitar, accompaniment
and notes mode, with ``stem_source`` "guitar" and "mix", and with the
template chord backend for each vocabulary (majmin7 reads the fused path;
majmin and majmin7plus decode the harmonic part again, salience chroma and
the constant-switch Viterbi on each package's device). Every artifact must
be equal: JSON parsed, ``.csv``/``.musicxml``/``.mid``/``.ly``/``.pdf`` as
bytes, ``profile.json`` (times) by keys; the returned ``JobResult`` as JSON.

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
analysis (XLA against torch): rtol 1e-5. Both packages decode with their
own decoders, the same C++ library built with the same flags, and the
decoded samples are equal (tests/test_torch_decode.py). Notes mode and a
fused analysis forced to fail are held against the JAX package the same way
(``_assert_pipelines_agree``); on the failure path every stage recomputes
its device work (HPSS, the BLSTM and DBN, the calibration statistics, Basic
Pitch in float32 on the song's length, DeepChroma and the CRF, the content
windows), and the float outputs of those stages (calibration statistics,
content metrics, note amplitudes) are float32 of two libraries: rtol 1e-5.
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


def _assert_same_artifacts(ref_dir: Path, got_dir: Path, skip: set = frozenset()):
    names = sorted(p.name for p in ref_dir.iterdir())
    assert sorted(p.name for p in got_dir.iterdir()) == names
    for name in sorted(set(names) - skip):
        ref, got = _read(ref_dir / name), _read(got_dir / name)
        if name == "profile.json":
            assert list(got) == list(ref)
        else:
            assert got == ref, name


def _tails(features, tmp_path, jax_env, stem_source: str, chord_rtol: float = 0.0, **settings):
    """The JAX and the port's ``_pipeline_tail`` on the same features under ``settings`` → (ref, got)."""
    from audiotabs_tpu.runtime.pipeline import StageTimer as JaxTimer
    from audiotabs_tpu.runtime.pipeline import _pipeline_tail as jax_tail
    from audiotabs_tpu_torch.runtime.pipeline import _pipeline_tail

    feats, y, native = features
    true_len = len(y)
    y_harm = np.asarray(feats["y_harm"], dtype=np.float32)[:true_len]
    common = dict(feats=feats, y_harm=y_harm, true_len=true_len, sr=SR, job_id="job", stem_source=stem_source,
                  beat_act_from_feats=True, y_native=native)
    jax_env(**settings)
    ref = jax_tail(**common, y=y, work=tmp_path / "jax_work", out=tmp_path / "jax", timer=JaxTimer(), errors=[], beat_source=None)
    got = _pipeline_tail(**common, out=tmp_path / "port", stages={}, errors=[], settings=Settings(**settings), device="cpu")
    assert ref.transcription_error is None and ref.score is not None
    got_json, ref_json = json.loads(got.to_json()), json.loads(ref.model_dump_json())
    if chord_rtol:
        # chords decoded again from the harmonic part: their confidences are
        # float32 salience of two libraries; labels and bounds stay exact
        _assert_same_chords(got_json.pop("chords"), ref_json.pop("chords"), chord_rtol)
        _assert_same_chords(_read(tmp_path / "port" / "chords.json"), _read(tmp_path / "jax" / "chords.json"), chord_rtol)
    assert got_json == ref_json
    _assert_same_artifacts(tmp_path / "jax", tmp_path / "port", skip={"chords.json"} if chord_rtol else set())
    return ref, got


def _assert_same_chords(got: list, ref: list, rtol: float):
    assert [{k: v for k, v in c.items() if k != "confidence"} for c in got] == [{k: v for k, v in c.items() if k != "confidence"} for c in ref]
    np.testing.assert_allclose([c["confidence"] for c in got], [c["confidence"] for c in ref], rtol=rtol)


@pytest.mark.parametrize("mode", ["guitar", "accompaniment", "notes"])
@pytest.mark.parametrize("stem_source", ["guitar", "mix"])
def test_tail_matches_jax_on_the_same_features(features, stem_source, mode, tmp_path, jax_env):
    _tails(features, tmp_path, jax_env, stem_source, TRANSCRIPTION_MODE=mode)
    names = {p.name for p in (tmp_path / "port").iterdir()}
    assert ARTIFACTS <= names
    assert "strum_onsets.json" in names if mode == "accompaniment" else mode == "guitar" or "strum_onsets.json" not in names


@pytest.mark.parametrize("vocab", ["majmin", "majmin7", "majmin7plus"])
def test_tail_template_backend_matches_jax(features, vocab, tmp_path, jax_env):
    # majmin7 reads the fused emissions and path (byte-equal); the other
    # vocabularies decode the harmonic part again: chord confidences rtol 1e-5
    _ref, got = _tails(features, tmp_path, jax_env, "guitar", chord_rtol=0.0 if vocab == "majmin7" else 1e-5,
                       CHORD_DETECTION_BACKEND="template", CHORD_VOCAB=vocab)
    assert got.chords and ARTIFACTS <= {p.name for p in (tmp_path / "port").iterdir()}


def _assert_pipelines_agree(ref_out: Path, got_out: Path, ref, got, metric_rtol: float = 1e-5):
    """Two run_pipeline jobs agree: the same artifact set; beat times, chord
    labels and bounds, key, time signature, content types, note rows
    (start, end, pitch, velocity) and the tab, MIDI, MusicXML and score files
    exactly; float32 posteriors and statistics of the device stages (chord
    confidences, key score, calibration characteristics) within rtol 1e-5,
    content metrics within ``metric_rtol``, note amplitudes within one f16
    ulp."""
    names = sorted(p.name for p in ref_out.iterdir())
    assert sorted(p.name for p in got_out.iterdir()) == names
    assert (ref.transcription_error, ref.transcription_backend) == (got.transcription_error, got.transcription_backend)
    ref_bt, got_bt = _read(ref_out / "beat_times.json"), _read(got_out / "beat_times.json")
    assert list(got_bt) == list(ref_bt)
    for field in ref_bt:
        assert got_bt[field] == ref_bt[field], field
    ref_ch, got_ch = _read(ref_out / "chords.json"), _read(got_out / "chords.json")
    assert [(c["start"], c["end"], c["label"]) for c in got_ch] == [(c["start"], c["end"], c["label"]) for c in ref_ch]
    np.testing.assert_allclose([c["confidence"] for c in got_ch], [c["confidence"] for c in ref_ch], rtol=1e-5)
    ref_key, got_key = ref.key_signature.model_dump(), got.key_signature.to_dict()
    np.testing.assert_allclose(got_key.pop("score"), ref_key.pop("score"), rtol=1e-5)
    assert (got_key, got.time_signature, got.tempo_bpm) == (ref_key, ref.time_signature, ref.tempo_bpm)
    if "content_segments.json" in names:
        ref_cs, got_cs = _read(ref_out / "content_segments.json"), _read(got_out / "content_segments.json")
        assert [(s["start"], s["end"], s["type"], s["confidence"]) for s in got_cs] == [(s["start"], s["end"], s["type"], s["confidence"]) for s in ref_cs]
        for a, b in zip(got_cs, ref_cs):
            assert list(a["metrics"]) == list(b["metrics"])
            np.testing.assert_allclose(list(a["metrics"].values()), list(b["metrics"].values()), rtol=metric_rtol)
    if "threshold_calibration.json" in names:
        ref_cal, got_cal = _read(ref_out / "threshold_calibration.json"), _read(got_out / "threshold_calibration.json")
        assert list(got_cal["characteristics"]) == list(ref_cal["characteristics"])
        np.testing.assert_allclose([*got_cal["characteristics"].values(), got_cal["onset_threshold"], got_cal["frame_threshold"]],
                                   [*ref_cal["characteristics"].values(), ref_cal["onset_threshold"], ref_cal["frame_threshold"]], rtol=1e-5)
    # note events row for row: no note opens, ends or flips differently
    ref_rows = [r.split(",") for r in (ref_out / "note_events.csv").read_text().splitlines()]
    got_rows = [r.split(",") for r in (got_out / "note_events.csv").read_text().splitlines()]
    assert len(ref_rows) > 5 and [r[:4] for r in got_rows] == [r[:4] for r in ref_rows]
    np.testing.assert_allclose([float(r[4]) for r in got_rows[1:]], [float(r[4]) for r in ref_rows[1:]], rtol=2**-10, atol=2**-14)
    for name in set(names) & {"result.musicxml", "transcription.mid", "score.ly", "score.pdf", "tab_positions.json",
                              "strum_onsets.json", "chosen_shapes.json"}:
        assert _read(got_out / name) == _read(ref_out / name), name


@pytest.mark.parametrize("clip", ["heldout_strum_band.wav", "heldout_picked_melody.wav"])
def test_run_pipeline_matches_jax(clip, tmp_path, jax_env):
    from audiotabs_tpu.io.wav import decode_for_analysis as jax_decode
    from audiotabs_tpu.runtime.pipeline import run_pipeline as jax_run
    from audiotabs_tpu_torch.io.wav import decode_for_analysis
    from audiotabs_tpu_torch.runtime.pipeline import run_pipeline

    path = _crop(clip, tmp_path)
    # the two decodes, each package its own: the same samples
    y_ref, _, writer, (x_ref, sr_ref) = jax_decode(path, tmp_path / "jax_mono.wav", SR)
    writer.join()
    y, _, (x, sr_nat) = decode_for_analysis(path, SR)
    assert sr_ref == sr_nat and np.array_equal(x_ref, x) and np.array_equal(y_ref, y)

    jax_env(ENABLE_DEMUCS="False", PAD_SECONDS_BUCKET="6")
    ref = jax_run(tmp_path / "jax" / "job", path)
    got = run_pipeline(tmp_path / "port" / "job", path, device="cpu", settings=CROP)
    ref_out, got_out = tmp_path / "jax" / "job" / "out", tmp_path / "port" / "job" / "out"
    assert ref.transcription_error is None and got.transcription_error is None
    _assert_pipelines_agree(ref_out, got_out, ref, got)
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


def test_failed_analysis_records_each_stage_and_writes_the_artifacts(tmp_path, monkeypatch, jax_env):
    """The fused analysis forced to fail in both packages: the only error is
    the analysis', and every stage recomputes its device work; the two jobs
    agree as ``_assert_pipelines_agree`` states."""
    import audiotabs_tpu.runtime.fused as jax_fused
    from audiotabs_tpu.runtime.pipeline import run_pipeline as jax_run
    from audiotabs_tpu_torch.runtime import pipeline

    def fail(*args, **kwargs):
        raise RuntimeError("forced")

    monkeypatch.setattr(pipeline, "fused_analysis", fail)
    monkeypatch.setattr(jax_fused, "fused_analysis", fail)
    path = _crop("heldout_strum_band.wav", tmp_path)
    jax_env(ENABLE_DEMUCS="False", PAD_SECONDS_BUCKET="6")
    ref = jax_run(tmp_path / "jax" / "job", path)
    result = pipeline.run_pipeline(tmp_path / "job", path, device="cpu", settings=CROP)
    assert result.transcription_error == ref.transcription_error == "analysis: forced"
    out = tmp_path / "job" / "out"
    assert json.loads((out / "beat_times.json").read_text())["errors"] == ["analysis: forced"]
    assert ARTIFACTS | {"content_segments.json", "strum_onsets.json", "chosen_shapes.json"} <= {p.name for p in out.iterdir()}
    assert result.chords and result.key_signature and result.score and result.transcription_backend == "guitar_hybrid"
    _assert_pipelines_agree(tmp_path / "jax" / "job" / "out", out, ref, result)
    for wav in ("audio_mono_44k.wav", "audio_harmonic.wav"):
        assert (tmp_path / "job" / "work" / wav).exists()


def test_notes_mode_is_not_ported(tmp_path, jax_env):
    """Notes mode (the test keeps its name from before notes mode was
    ported): ``run_pipeline`` on a crop, and ``run_pipeline_from_features``
    on the port's features of the crop, against the JAX package."""
    from audiotabs_tpu.runtime.pipeline import run_pipeline as jax_run
    from audiotabs_tpu.runtime.pipeline import run_pipeline_from_features as jax_from_features
    from audiotabs_tpu_torch.io.wav import decode_for_analysis
    from audiotabs_tpu_torch.runtime.pipeline import run_analysis, run_pipeline, run_pipeline_from_features

    notes = dataclasses.replace(CROP, TRANSCRIPTION_MODE="notes")
    path = _crop(HELDOUT[0], tmp_path)
    jax_env(ENABLE_DEMUCS="False", PAD_SECONDS_BUCKET="6", TRANSCRIPTION_MODE="notes")
    ref = jax_run(tmp_path / "jax" / "job", path)
    got = run_pipeline(tmp_path / "port" / "job", path, device="cpu", settings=notes)
    assert got.transcription_error is None and got.transcription_backend == "basicpitch_jax_cnn"
    _assert_pipelines_agree(tmp_path / "jax" / "job" / "out", tmp_path / "port" / "job" / "out", ref, got)

    feats, _beats, _info = run_analysis(path, device="cpu", settings=notes)
    true_len = len(decode_for_analysis(path, SR)[0])
    ref = jax_from_features(feats, true_len, SR, tmp_path / "jax" / "jobs" / "b1", stem_source="mix")
    got = run_pipeline_from_features(feats, true_len, SR, tmp_path / "port" / "jobs" / "b1", stem_source="mix", settings=notes, device="cpu")
    assert got.transcription_error is None and json.loads(got.to_json()) == json.loads(ref.model_dump_json())
    _assert_same_artifacts(tmp_path / "jax" / "jobs" / "b1" / "out", tmp_path / "port" / "jobs" / "b1" / "out")


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
