"""The host separation path, the weight-free beat activation and the median
kernel's autograd guard, against the JAX package on the CPU.

- ``apply_model`` (stereo, 44.1 kHz, two shifts from numpy's generator) and
  ``separate_stems`` / ``separate_stems_device`` off the device path
  (48 kHz and 16 kHz mono, a 2-D input): each stem within 1e-5 of the
  reference's peak, as tests/test_torch_htdemucs.py holds the separation
  program. A tiny 4-source checkpoint (the port's ``init_params(channels=8,
  bottom=64, t_layers=2)``, in the JAX layout, with ``meta_segment`` 24576)
  is written to a temporary file and named by ``HTDEMUCS_WEIGHTS`` for both
  packages.
- ``onset_activation`` on a held-out crop: atol 1e-5.
- ``run_analysis`` with ``BEAT_RNN_WEIGHTS=off``: ``dbn_phases``,
  ``dbn_intervals`` and the beat times equal to the JAX package's, the f16
  activation within one f16 ulp.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import audiotabs_tpu.models.beat_rnn as jbr
import audiotabs_tpu.models.htdemucs as jhd
from audiotabs_tpu.decode.dbn_beats import beats_from_decoded as jax_beats
from audiotabs_tpu.io.wav import write_wav
from audiotabs_tpu.runtime.fused import fused_analysis as jax_fused
from audiotabs_tpu_torch import tracing
from audiotabs_tpu_torch.config import Settings
from audiotabs_tpu_torch.io.wav import decode_for_analysis, load_wav, peak_normalize
from audiotabs_tpu_torch.models import beat_rnn, htdemucs
from audiotabs_tpu_torch.ops import median
from audiotabs_tpu_torch.runtime import fused
from audiotabs_tpu_torch.runtime.pipeline import ANALYSIS_SR, _pad_to_bucket, run_analysis
from test_torch_fused import torch_threads  # noqa: F401 (an autouse fixture)

HELDOUT = Path(__file__).parent / "data" / "heldout"
SEG = 24576  # at least the largest shift (0.5 s at 44.1 kHz), as every real checkpoint's segment is
L44 = 8820  # every call below separates 0.2 s at 44.1 kHz: the JAX forward compiles once per window count


def _rel(got, ref) -> float:
    return float(np.abs(np.asarray(got) - np.asarray(ref)).max() / np.abs(np.asarray(ref)).max())


@pytest.fixture(scope="module")
def tiny_params():
    # the port's init (JAX layout): separation parity needs the same weights
    # on both sides, not the JAX init, whose trace compiles for half a minute here
    params = htdemucs.init_params(torch.Generator().manual_seed(0), n_sources=4, channels=8, bottom=64, t_layers=2)
    rng = np.random.default_rng(4)

    def redraw(node):  # LayerScale gains in [0.2, 0.8], so that every residual branch moves the output
        if isinstance(node, list):
            return [redraw(v) for v in node]
        if isinstance(node, dict):
            return {k: rng.uniform(0.2, 0.8, v.shape).astype(np.float32) if k in ("scale", "gamma1", "gamma2") else redraw(v)
                    for k, v in node.items()}
        return node

    return {**redraw(params), "meta_segment": np.asarray(SEG, np.int64)}


@pytest.fixture
def tiny_checkpoint(tiny_params, tmp_path, monkeypatch):
    path = tmp_path / "htdemucs_tiny.npz"
    htdemucs.save_params(str(path), tiny_params)
    monkeypatch.setenv("HTDEMUCS_WEIGHTS", str(path))
    monkeypatch.setattr(jhd, "_PARAMS", None)  # the JAX host path caches the first checkpoint it read
    return path


def test_apply_model_stereo_two_shifts_matches_jax(tiny_params):
    mix = (0.1 * np.random.default_rng(1).standard_normal((2, L44))).astype(np.float32)
    run = {k: v for k, v in tiny_params.items() if k != "meta_segment"}
    ref = jhd.apply_model(tiny_params, mix, 44100, shifts=2)
    got = htdemucs.apply_model(htdemucs.HTDemucs.from_params(run), mix, 44100, shifts=2, segment=SEG)
    assert got.shape == ref.shape == (4, 2, L44)
    assert _rel(got, ref) < 1e-5


@pytest.mark.parametrize("sr", [48000, 16000])
def test_separate_stems_other_rates_match_jax(tiny_checkpoint, sr):
    y = (0.1 * np.random.default_rng(2).standard_normal(sr // 5)).astype(np.float32)
    ref = jhd.separate_stems(y, sr)
    got = htdemucs.separate_stems(y, sr, device="cpu")
    assert list(got) == list(ref) == ["drums", "bass", "other", "vocals"]
    for name in ref:
        assert got[name].shape == ref[name].shape == y.shape
        assert _rel(got[name], ref[name]) < 1e-5, name
    # the device entry point routes this rate to the host path, as the JAX one does
    ref_dev = jhd.separate_stems_device(y, sr)
    got_dev = htdemucs.separate_stems_device(torch.from_numpy(y), sr)
    for name in ref:
        assert isinstance(got_dev[name], torch.Tensor) and got_dev[name].device.type == "cpu"
        assert _rel(got_dev[name].numpy(), np.asarray(ref_dev[name])) < 1e-5, name


def test_separate_stems_two_dimensional_input_matches_jax(tiny_checkpoint):
    """A [ch, L] input skips the pseudo-stereo stacking; as in the JAX package
    each stem is then cut to len(y), the channel count (ROADMAP.md §3)."""
    y = (0.1 * np.random.default_rng(3).standard_normal((2, L44))).astype(np.float32)
    ref = jhd.separate_stems(y, 44100)
    got = htdemucs.separate_stems(y, 44100, device="cpu")
    got_dev = htdemucs.separate_stems_device(torch.from_numpy(y), 44100)
    for name in ref:
        assert got[name].shape == ref[name].shape == (2,)
        np.testing.assert_allclose(got[name], ref[name], rtol=1e-5, atol=1e-6 * float(np.abs(y).max()))
        np.testing.assert_array_equal(got_dev[name].numpy(), got[name])


def test_onset_activation_matches_jax():
    y, sr = load_wav(HELDOUT / "heldout_picked_melody.wav")
    crop = peak_normalize(y[2 * sr : 9 * sr]).astype(np.float32)
    ref = np.asarray(jbr.onset_activation(jnp.asarray(crop), sr, 100))
    got = beat_rnn.onset_activation(torch.from_numpy(crop), sr, 100).numpy()
    assert got.shape == ref.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, ref, atol=1e-5)
    # an empty ensemble is the weight-free activation
    np.testing.assert_array_equal(beat_rnn.beat_activation(torch.from_numpy(crop), sr, []).numpy(), got)


def test_run_analysis_without_beat_weights_matches_jax(tmp_path, monkeypatch):
    """A 4 s crop in a 5 s bucket (a shape no other test traces the JAX fused
    program at, so its jit cache holds no trace made with the checkpoint)."""
    monkeypatch.setenv("BEAT_RNN_WEIGHTS", "off")
    monkeypatch.setattr(jbr, "_TRAINED", None)
    monkeypatch.setattr(jbr, "_TRAINED_CHECKED", True)
    fused.load_models.cache_clear()
    try:
        x, sr = load_wav(HELDOUT / "heldout_strum_band.wav", mono=False)
        path = tmp_path / "crop.wav"
        write_wav(path, x[4 * sr : 8 * sr], sr)
        settings = Settings(ENABLE_DEMUCS=False, PAD_SECONDS_BUCKET=5.0)
        feats, beats, info = run_analysis(path, device="cpu", settings=settings)
        assert fused.load_models(torch.device("cpu")).beat == []
    finally:
        fused.load_models.cache_clear()
    assert info == {"stem_source": "mix", "errors": []}
    y, _, _ = decode_for_analysis(path, ANALYSIS_SR)
    y = peak_normalize(y)
    y_pad = _pad_to_bucket(y, ANALYSIS_SR, settings.PAD_SECONDS_BUCKET)
    ref = jax.device_get(jax_fused(jnp.asarray(y_pad), ANALYSIS_SR, chord_backend="deep", true_len=len(y)))
    np.testing.assert_array_equal(feats["dbn_phases"], np.asarray(ref["dbn_phases"]))
    np.testing.assert_array_equal(feats["dbn_intervals"], np.asarray(ref["dbn_intervals"]))
    np.testing.assert_allclose(feats["beat_activation"].astype(np.float32), np.asarray(ref["beat_activation"], np.float32),
                               rtol=2**-10, atol=2**-14)
    t100 = int(len(y) / ANALYSIS_SR * 100)
    ref_beats = jax_beats(np.asarray(ref["dbn_phases"])[:t100], np.asarray(ref["dbn_intervals"])[:t100],
                          np.asarray(ref["beat_activation"], np.float32)[:t100], fps=100)
    assert beats.size > 0
    np.testing.assert_array_equal(beats, ref_beats)


def test_median_kernel_refuses_a_device_tensor_that_requires_grad():
    """The kernel has no backward: a device tensor in a graph raises before any
    launch (a meta tensor stands in for a CUDA one here); under no_grad, or on
    the CPU's plain version, it does not."""
    x = torch.rand(8, 40, device="meta", requires_grad=True)
    launches = tracing.counters().get("median_filter_launches", 0)
    with pytest.raises(RuntimeError, match="no backward"):
        median.median_filter(x, 5)
    assert tracing.counters().get("median_filter_launches", 0) == launches
    with torch.no_grad(), pytest.raises(ValueError, match="cuda or cpu"):
        median.median_filter(x, 5)  # past the guard: the meta device is refused as before
    cpu = torch.rand(8, 40, requires_grad=True)
    assert median.median_filter(cpu, 5).shape == (8, 40)


def test_shifts_eval_matches_jax(tiny_checkpoint, monkeypatch, capsys):
    """The shifts report on one held-out multitrack (the JAX tool takes 8)
    through the device program at 44.1 kHz, shifts 1 and 2."""
    import json

    import audiotabs_tpu.train.shifts_eval as jse
    from audiotabs_tpu_torch.train import shifts_eval

    build = jse.build_clips
    monkeypatch.setattr(jse, "build_clips", lambda n, *a, **k: build(1, *a, **k))
    assert jse.main() == 0
    ref = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    got = shifts_eval.evaluate("cpu", n_val=1)
    assert got["n_sources"] == ref["n_sources"] == 4 and got["stem"] == ref["stem"] == "other"
    for shifts in (1, 2):
        key = f"val_other_sisdr_shifts{shifts}"
        assert got[key] == pytest.approx(ref[key], abs=2e-3), key
