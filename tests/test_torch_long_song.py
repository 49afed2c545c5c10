"""The JAX package's north-star song, 180 s, through both packages on the CPU.

``bench.py``'s ``make_test_audio(180.0)`` (a chord pad, a melody and clicks)
with ``true_len`` half a second short goes through the JAX
``fused_analysis`` and the port's, ``chord_backend="deep"``, and every
output must agree: the discrete outputs (``crf_path``, ``dbn_phases``,
``dbn_intervals``, ``content_starts``) and the beat times exactly, the f16
outputs within one f16 ulp (rtol 2^-10, as ``tests/test_torch_fused.py``),
every other float within rtol 1e-3, atol 1e-5. One element may differ
more: the onset density of one content window (``content_metrics[w, 1]``,
onsets per second of a 3 s window) may be one onset, 1/3, apart. That is a
knife edge, not a fault: fed the same envelope the two onset pickers agree,
but the window's envelopes differ by float32 rounding (at most 9.9e-4 on a
scale of 72.6), and at one frame the envelope lies 3e-4 from its threshold,
``mean + delta``, above it in one package and below it in the other. The
180 s shapes are pinned, and the generator ``chip_smoke.py`` runs (it
imports ``bench.py``'s; the port does not) must give bench.py's bytes.

Both analyses run once for the module: about 110 s of JAX (most of it XLA
constant-folding the HPSS scatters) and 25 s of the port, two torch threads.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from audiotabs_tpu.decode.dbn_beats import beats_from_decoded as jax_beats
from audiotabs_tpu.runtime.fused import fused_analysis as jax_fused
from audiotabs_tpu_torch.decode.dbn_beats import beats_from_decoded
from audiotabs_tpu_torch.runtime.fused import F16_OUTPUTS, fused_analysis
from audiotabs_tpu_torch.runtime.pipeline import ANALYSIS_SR, features_to_host
from test_torch_fused import torch_threads  # noqa: F401 (an autouse fixture)

REPO = Path(__file__).resolve().parents[1]
SR = ANALYSIS_SR
LONG_S = 180.0
DISCRETE = ("crf_path", "dbn_phases", "dbn_intervals", "content_starts")
OUTPUTS = (
    "y_harm", "beat_activation", "amt_onset", "amt_frame", "chroma", "chord_energy", "chord_emissions", "dc_chroma",
    "crf_path", "crf_conf", "dbn_phases", "dbn_intervals", "strum_envelope", "content_starts", "content_metrics",
    "key_probs", "char_rms_median", "char_noise_rms", "char_centroid", "char_rolloff", "char_harm_ratio",
    "char_onset_density",
)
ONSET_DENSITY = 1  # the column of content_metrics: onsets per second of the window
# the 180 s song's shapes: 100 fps beat frames, 256-sample hCQT frames, 10 fps
# chord frames, 512-sample strum frames, 3 s windows every 1.5 s
SHAPES = {"beat_activation": (18041,), "amt_onset": (15504, 88), "chroma": (12, 1801), "crf_path": (1801,),
          "strum_envelope": (7752,), "content_starts": (120,), "content_metrics": (120, 4)}


def _load(name: str):
    """A module of the repository's root by path (``bench.py``, ``chip_smoke.py``)."""
    spec = importlib.util.spec_from_file_location(f"_long_song_{name}", REPO / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def bench():
    return _load("bench")


@pytest.fixture(scope="module")
def long_song(bench):
    y = bench.make_test_audio(LONG_S, SR)
    true_len = len(y) - SR // 2  # the last 0.5 s stands for a wrap-padded tail
    ref = jax.device_get(jax_fused(jnp.asarray(y), SR, chord_backend="deep", true_len=true_len))
    with torch.inference_mode():
        got = features_to_host(fused_analysis(torch.from_numpy(y), SR, chord_backend="deep", true_len=true_len))
    return {k: np.asarray(v) for k, v in ref.items()}, got, true_len


@pytest.mark.parametrize("seconds", [30.0, LONG_S])
def test_chip_smoke_generator_is_bench_py_byte_for_byte(bench, seconds):
    ours = _load("chip_smoke").make_test_audio(seconds, SR)
    assert ours.dtype == np.float32 and ours.shape == (int(seconds * SR),)
    assert ours.tobytes() == bench.make_test_audio(seconds, SR).tobytes()


def test_long_song_outputs_and_shapes(long_song):
    ref, got, _ = long_song
    assert set(got) == set(ref) == set(OUTPUTS)
    for k in OUTPUTS:
        assert got[k].dtype == ref[k].dtype and got[k].shape == ref[k].shape, k
    for k, shape in SHAPES.items():
        assert got[k].shape == shape, k


@pytest.mark.parametrize("key", [k for k in OUTPUTS if k != "content_metrics"])
def test_long_song_output_matches_jax(long_song, key):
    ref, got, _ = long_song
    a, b = ref[key], got[key]
    if key in DISCRETE:
        np.testing.assert_array_equal(b, a, err_msg=key)
    elif key in F16_OUTPUTS:
        np.testing.assert_allclose(b.astype(np.float32), a.astype(np.float32), rtol=2**-10, atol=2**-14, err_msg=key)
    else:
        np.testing.assert_allclose(b, a, rtol=1e-3, atol=1e-5, err_msg=key)


def test_long_song_content_metrics_match_jax_but_one_onset_knife_edge(long_song):
    ref, got, _ = long_song
    a, b = ref["content_metrics"], got["content_metrics"]
    others = np.delete(np.arange(a.shape[1]), ONSET_DENSITY)
    np.testing.assert_allclose(b[:, others], a[:, others], rtol=1e-3, atol=1e-5)
    bad = ~np.isclose(b[:, ONSET_DENSITY], a[:, ONSET_DENSITY], rtol=1e-3, atol=1e-5)
    assert bad.sum() <= 1, np.nonzero(bad)[0]
    # one onset of a 3 s window, where the envelope sits on its threshold
    np.testing.assert_allclose(np.abs(b[bad, ONSET_DENSITY] - a[bad, ONSET_DENSITY]), 1.0 / 3.0, rtol=1e-5)


def test_long_song_beat_times_match_jax(long_song):
    ref, got, true_len = long_song
    t100 = int(true_len / SR * 100)
    ours = beats_from_decoded(got["dbn_phases"][:t100], got["dbn_intervals"][:t100],
                              got["beat_activation"].astype(np.float32)[:t100], fps=100)
    theirs = jax_beats(ref["dbn_phases"][:t100], ref["dbn_intervals"][:t100],
                       ref["beat_activation"].astype(np.float32)[:t100], fps=100)
    assert ours.size > 100
    np.testing.assert_array_equal(ours, theirs)
