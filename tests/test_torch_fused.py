"""The ported slice as a whole against the JAX ``fused_analysis``, real checkpoints.

Two kinds of input: a synthetic chord clip with a wrap-padded tail, and a
5 s crop of each of the six held-out clips (44.1 kHz stereo or 22.05 kHz
mono) driven through ``run_analysis`` on the CPU with ``ENABLE_DEMUCS=False``
(the mix analysed; separation is held against JAX in
tests/test_torch_separation.py), whose decode, resample and bucket padding
feed both packages.
Tolerances: discrete outputs (``crf_path``, ``dbn_phases``,
``dbn_intervals``, ``content_starts``) and beat times exactly; the f16
outputs within one f16 ulp (rtol 2^-10); other floats rtol 1e-3, atol 1e-5.
Each JAX configuration compiles once per module (every crop shares the
6 s bucket).
"""

from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from audiotabs_tpu.decode.dbn_beats import beats_from_decoded as jax_beats
from audiotabs_tpu.io.wav import write_wav
from audiotabs_tpu.runtime.fused import fused_analysis as jax_fused
from audiotabs_tpu_torch.config import Settings
from audiotabs_tpu_torch.io.wav import decode_for_analysis, peak_normalize
from audiotabs_tpu_torch.runtime.fused import F16_OUTPUTS, fused_analysis
from audiotabs_tpu_torch.runtime.pipeline import ANALYSIS_SR, _pad_to_bucket, features_to_host, run_analysis

SR = ANALYSIS_SR
HELDOUT = sorted(p.name for p in (Path(__file__).parent / "data" / "heldout").glob("*.wav"))
DISCRETE = ("crf_path", "dbn_phases", "dbn_intervals", "content_starts")


@pytest.fixture(scope="module", autouse=True)
def torch_threads():
    """Two intra-op threads for this module: the suite runs files in parallel
    workers, and torch's default of one thread per core oversubscribes the
    cores (a 5 s crop's run_analysis took 270 s beside five busy processes,
    12 s with 2 threads)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _chord(pitches, dur, amp=0.25):
    t = np.arange(int(SR * dur)) / SR
    return sum(amp * np.sin(2 * np.pi * 440.0 * 2 ** ((p - 69) / 12) * t) for p in pitches)


@pytest.fixture(scope="module")
def synthetic():
    rng = np.random.default_rng(0)
    y = np.concatenate([_chord((48, 52, 55), 2.0), _chord((45, 48, 52), 2.0)])
    y = (y + 0.01 * rng.standard_normal(len(y))).astype(np.float32)
    true_len = len(y) - SR // 2  # the last 0.5 s stands for the wrap-padded tail
    ref = jax.device_get(jax_fused(jnp.asarray(y), SR, chord_backend="deep", true_len=true_len))
    with torch.inference_mode():
        got = features_to_host(fused_analysis(torch.from_numpy(y), SR, chord_backend="deep", true_len=true_len))
    return ref, got


@pytest.fixture(scope="module", params=HELDOUT)
def heldout(request, tmp_path_factory):
    from audiotabs_tpu.io.wav import read_wav

    x, sr = read_wav(Path(__file__).parent / "data" / "heldout" / request.param)
    path = tmp_path_factory.mktemp("heldout") / "crop.wav"
    write_wav(path, x[3 * sr : 8 * sr], sr)
    settings = Settings(ENABLE_DEMUCS=False, PAD_SECONDS_BUCKET=6.0)
    feats, beats, info = run_analysis(path, device="cpu", settings=settings)
    assert info == {"stem_source": "mix", "errors": []}
    # the JAX reference on the same decoded, normalised, padded input
    y, _, _ = decode_for_analysis(path, SR)
    y = peak_normalize(y)
    y_pad = _pad_to_bucket(y, SR, settings.PAD_SECONDS_BUCKET)
    ref = jax.device_get(jax_fused(jnp.asarray(y_pad), SR, chord_backend="deep", true_len=len(y)))
    t100 = int(len(y) / SR * 100)
    ref_beats = jax_beats(
        np.asarray(ref["dbn_phases"])[:t100], np.asarray(ref["dbn_intervals"])[:t100],
        np.asarray(ref["beat_activation"], dtype=np.float32)[:t100], fps=100,
    )
    return ref, feats, ref_beats, beats, len(y_pad)


def _compare(ref: dict, got: dict):
    assert set(got) == set(ref)
    for k in ref:
        a = np.asarray(ref[k])
        b = got[k]
        assert b.dtype == a.dtype and b.shape == a.shape, (k, b.dtype, a.dtype, b.shape, a.shape)
        if k in DISCRETE:
            np.testing.assert_array_equal(b, a, err_msg=k)
        elif k in F16_OUTPUTS:
            np.testing.assert_allclose(b.astype(np.float32), a.astype(np.float32), rtol=2**-10, atol=2**-14, err_msg=k)
        else:
            np.testing.assert_allclose(b, a, rtol=1e-3, atol=1e-5, err_msg=k)


def test_fused_synthetic_matches_jax(synthetic):
    _compare(*synthetic)


def test_fused_synthetic_masks_tail_and_decodes_chords(synthetic):
    _ref, got = synthetic
    from audiotabs_tpu_torch.models.crf_chords import LABELS

    path = [LABELS[s] for s in got["crf_path"]]
    assert set(path[3:17]) == {"C:maj"}, path
    assert "A:min" in path[22:36], path
    # past true_len the chord emissions are uniform
    np.testing.assert_allclose(got["chord_emissions"][:, -3:], 1.0 / got["chord_emissions"].shape[0])


def test_run_analysis_heldout_crop_matches_jax(heldout):
    ref, feats, _, _, _ = heldout
    _compare(ref, feats)


def test_run_analysis_heldout_crop_beats_match_jax(heldout):
    _, feats, ref_beats, beats, n_pad = heldout
    assert beats.dtype == np.float32 and beats.size > 0
    np.testing.assert_array_equal(beats, ref_beats)
    assert feats["y_harm"].shape == (n_pad,)
