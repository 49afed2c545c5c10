"""The port's run_pipeline against the JAX package's under the settings the
fused features do not cover alone: the template chord backend for each
vocabulary, and content windows other than the shipped 3 s / 1.5 s.

A 5 s crop of ``heldout_strum_band`` (the chordal clip, whose guitar mode
classifies windows and strums), ``ENABLE_DEMUCS=False``, each package with
its own decoders. The jobs agree as tests/test_torch_pipeline.py's
``_assert_pipelines_agree`` states: discrete outputs and the score files
exactly, float32 posteriors and statistics within rtol 1e-5. The content
metrics of the 4 s windows are computed from each package's own harmonic
stem, the fused analysis' float16 output (the two agree within one f16
ulp), so they agree within rtol 1e-4 (6.7e-5 seen on the periodicity).
"""

from __future__ import annotations

import dataclasses

import pytest

from test_torch_pipeline import CROP, _assert_pipelines_agree, _crop, _read, jax_env, torch_threads  # noqa: F401 (fixtures)

CASES = {
    "template-majmin": dict(CHORD_DETECTION_BACKEND="template", CHORD_VOCAB="majmin"),
    "template-majmin7": dict(CHORD_DETECTION_BACKEND="template", CHORD_VOCAB="majmin7"),
    "template-majmin7plus": dict(CHORD_DETECTION_BACKEND="template", CHORD_VOCAB="majmin7plus"),
    "content-4s-2s": dict(CONTENT_ANALYSIS_WINDOW_SEC=4.0, CONTENT_ANALYSIS_HOP_SEC=2.0),
}


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    return _crop("heldout_strum_band.wav", tmp_path_factory.mktemp("crop"))


@pytest.mark.parametrize("case", list(CASES))
def test_run_pipeline_setting_matches_jax(case, clip, tmp_path, jax_env):
    from audiotabs_tpu.runtime.pipeline import run_pipeline as jax_run
    from audiotabs_tpu_torch.runtime.pipeline import run_pipeline

    settings = CASES[case]
    jax_env(ENABLE_DEMUCS="False", PAD_SECONDS_BUCKET="6", **settings)
    ref = jax_run(tmp_path / "jax" / "job", clip)
    got = run_pipeline(tmp_path / "port" / "job", clip, device="cpu", settings=dataclasses.replace(CROP, **settings))
    assert ref.transcription_error is None and got.transcription_error is None and got.chords
    out = tmp_path / "port" / "job" / "out"
    _assert_pipelines_agree(tmp_path / "jax" / "job" / "out", out, ref, got, metric_rtol=1e-4 if case.startswith("content") else 1e-5)
    if case == "template-majmin7":
        # the tail reads the fused template decode: emissions, chroma and path
        from audiotabs_tpu_torch.runtime.pipeline import run_analysis

        feats, _, _ = run_analysis(clip, device="cpu", settings=dataclasses.replace(CROP, **settings))
        assert {"chord_emissions", "chroma", "chord_path", "chord_conf"} <= set(feats) and "crf_path" not in feats
    if case.startswith("content"):
        spans = [(s["start"], s["end"]) for s in _read(out / "content_segments.json")]
        assert spans[0][0] == 0.0 and spans[0][1] in (4.0, 5.0)  # 4 s windows, not the fused 3 s
