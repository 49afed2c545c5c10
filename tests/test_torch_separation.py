"""The shipped configuration (``ENABLE_DEMUCS=True``) against the JAX pipeline, on the CPU.

Input: a 5 s crop (3–8 s) of ``heldout_strum_band`` in the 6 s bucket, which
the separation program cuts into 3 windows. The port's ``run_analysis``
against the JAX package's ``separate_stems_device`` and
``fused_analysis(y=guitar, y_beat=drums, y_mix=mix)`` on the same decoded,
normalised, padded input. Tolerances:

- stems: the largest error within 1e-5 of each stem's peak (measured about
  1e-6; both packages share the STFT framing and the resampling matrices);
- same stems (the JAX stems fed to both fused analyses): every output as
  tests/test_torch_fused.py compares it, the discrete ones exactly; once
  with the drums stem as the beat source (on this crop it holds 0.7 % of
  the mix RMS, so the gate takes the mix fallback) and once with the vocals
  stem in its place (50 %, so the gate passes it through);
- end to end (each package on its own stems): ``beat_from_drums``, the
  discrete outputs and the beat times exactly;
- weights off (``HTDEMUCS_WEIGHTS=off``, the HPSS fallback): as same stems.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from audiotabs_tpu.decode.dbn_beats import beats_from_decoded as jax_beats
from audiotabs_tpu.io.wav import read_wav, write_wav
from audiotabs_tpu.models import htdemucs as jax_htdemucs
from audiotabs_tpu.runtime.fused import fused_analysis as jax_fused
from audiotabs_tpu_torch.config import Settings
from audiotabs_tpu_torch.io.wav import decode_for_analysis, peak_normalize
from audiotabs_tpu_torch.models import htdemucs
from audiotabs_tpu_torch.runtime.fused import fused_analysis
from audiotabs_tpu_torch.runtime.pipeline import ANALYSIS_SR, _pad_to_bucket, features_to_host, run_analysis
from test_torch_fused import DISCRETE, _compare, torch_threads  # noqa: F401 (an autouse fixture)

SR = ANALYSIS_SR
HELDOUT = "tests/data/heldout/heldout_strum_band.wav"
SETTINGS = Settings(PAD_SECONDS_BUCKET=6.0)
STEM_TOL = 1e-5


def _beats(feats: dict, true_len: int, beats_fn) -> np.ndarray:
    t100 = int(true_len / SR * 100)
    return beats_fn(np.asarray(feats["dbn_phases"])[:t100], np.asarray(feats["dbn_intervals"])[:t100],
                    np.asarray(feats["beat_activation"], dtype=np.float32)[:t100], fps=100)


@pytest.fixture(scope="module")
def crop(tmp_path_factory):
    x, sr = read_wav(HELDOUT)
    path = tmp_path_factory.mktemp("separation") / "crop.wav"
    write_wav(path, x[3 * sr : 8 * sr], sr)
    y, _, _ = decode_for_analysis(path, SR)
    y = peak_normalize(y)
    return path, _pad_to_bucket(y, SR, SETTINGS.PAD_SECONDS_BUCKET), len(y)


@pytest.fixture(scope="module")
def jax_run(crop):
    _, y_pad, true_len = crop
    stems = jax_htdemucs.separate_stems_device(y_pad, SR, model_name="htdemucs_6s", shifts=1, bf16=False)
    ref = jax.device_get(jax_fused(stems["guitar"], SR, chord_backend="deep", true_len=true_len,
                                   y_beat=stems["drums"], y_mix=jnp.asarray(y_pad)))
    return {k: np.array(v) for k, v in stems.items()}, ref, _beats(ref, true_len, jax_beats)


@pytest.fixture(scope="module")
def port_run(crop):
    path, _, _ = crop
    return run_analysis(path, device="cpu", settings=SETTINGS)


def test_separation_program_config_is_three_windows(crop):
    cfg = htdemucs.program_config(htdemucs.load_params(), "htdemucs_6s", SETTINGS.stem_priority())
    n44 = 2 * len(crop[1])
    assert len(htdemucs._segment_windows(n44, cfg["seg"], cfg["stride"])) == 3


def test_stems_match_jax(crop, jax_run):
    _, y_pad, _ = crop
    ref, _, _ = jax_run
    got = htdemucs.separate_stems_device(torch.from_numpy(y_pad), SR, shifts=SETTINGS.DEMUCS_SHIFTS)
    assert list(got) == list(ref) == ["drums", "bass", "other", "vocals", "guitar", "piano"]
    for name, a in ref.items():
        b = got[name].numpy()
        assert b.shape == a.shape == y_pad.shape
        rel = np.abs(b - a).max() / np.abs(a).max()
        assert rel < STEM_TOL, (name, rel)


def test_run_analysis_separates_and_tracks_drums(jax_run, port_run):
    _, ref, _ = jax_run
    feats, _, info = port_run
    assert info == {"stem_source": "guitar", "errors": []}
    assert feats["beat_from_drums"].dtype == np.bool_ and feats["beat_from_drums"].shape == ()
    assert feats["beat_from_drums"] == ref["beat_from_drums"]


@pytest.mark.parametrize("beat_stem,from_drums", [("drums", False), ("vocals", True)])
def test_fused_on_the_same_stems_matches_jax(crop, jax_run, beat_stem, from_drums):
    _, y_pad, true_len = crop
    stems, ref, ref_beats = jax_run
    if beat_stem != "drums":
        ref = jax.device_get(jax_fused(jnp.asarray(stems["guitar"]), SR, chord_backend="deep", true_len=true_len,
                                       y_beat=jnp.asarray(stems[beat_stem]), y_mix=jnp.asarray(y_pad)))
        ref_beats = _beats(ref, true_len, jax_beats)
    with torch.inference_mode():
        out = fused_analysis(torch.from_numpy(stems["guitar"]), SR, chord_backend="deep", true_len=true_len,
                             y_beat=torch.from_numpy(stems[beat_stem]), y_mix=torch.from_numpy(y_pad))
        got = features_to_host(out)
    assert bool(got["beat_from_drums"]) is from_drums
    _compare(ref, got)
    np.testing.assert_array_equal(_beats(got, true_len, jax_beats), ref_beats)


def test_run_analysis_end_to_end_matches_jax(jax_run, port_run):
    _, ref, ref_beats = jax_run
    feats, beats, _ = port_run
    assert set(feats) == set(ref)
    for k in DISCRETE:
        np.testing.assert_array_equal(feats[k], np.asarray(ref[k]), err_msg=k)
    np.testing.assert_array_equal(beats, ref_beats)


def test_run_analysis_weights_off_takes_the_hpss_fallback(crop, monkeypatch):
    path, y_pad, true_len = crop
    monkeypatch.setenv("HTDEMUCS_WEIGHTS", "off")
    feats, beats, info = run_analysis(path, device="cpu", settings=SETTINGS)
    assert info == {"stem_source": "hpss_harmonic", "errors": []}
    ref = jax.device_get(jax_fused(jnp.asarray(y_pad), SR, separate=True, chord_backend="deep", true_len=true_len))
    _compare(ref, feats)
    np.testing.assert_array_equal(beats, _beats(ref, true_len, jax_beats))


def test_run_analysis_records_a_failed_separation_and_analyses_the_mix(crop, monkeypatch):
    from audiotabs_tpu_torch.runtime import pipeline

    def fail(*args, **kwargs):
        raise RuntimeError("out of memory")

    monkeypatch.setattr(pipeline, "separate_stems_device", fail)
    feats, beats, info = run_analysis(crop[0], device="cpu", settings=SETTINGS)
    assert info == {"stem_source": "mix", "errors": ["separation: out of memory"]}
    assert "beat_from_drums" not in feats and beats.size > 0
