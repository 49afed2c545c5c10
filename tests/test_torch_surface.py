"""The port's public surface against the JAX package's.

- Every name in the ``__all__`` of every JAX subpackage resolves in the
  port's counterpart, under the same name but for the renames in
  ``RENAMED`` (each with its reason).
- The public functions the earlier slices left out, each against its JAX
  counterpart on the same inputs: ``ops.magnitude_db`` and ``num_frames``,
  ``decode.estimate_beats`` (on the click track of
  ``tests/test_decode.py``), ``io.resample_kernel`` (44.1 → 22.05 kHz and
  16 → 22.05 kHz), ``models.htdemucs.convert_torch_state_dict`` (a random
  released-layout state dict through the port's forward and the JAX one,
  within ``tests/test_torch_htdemucs.py``'s 1e-5 of the peak) and
  ``score.lead_sheet.export_lead_sheet_musicxml`` (byte-equal).
"""

from __future__ import annotations

import ast
import importlib
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from test_torch_fused import torch_threads  # noqa: F401 (an autouse fixture)

REPO = Path(__file__).resolve().parents[1]
JAX_PACKAGES = sorted(p.parent.name for p in (REPO / "audiotabs_tpu").glob("*/__init__.py"))
# JAX name -> the port's name, and why
RENAMED = {
    ("io", "resample_kernel_jax"): ("resample_kernel", "the port's device resampler runs on torch tensors, not JAX"),
}
F32_TOL = 1e-5  # tests/test_torch_htdemucs.py: the largest error over the reference's peak


def _jax_all(pkg: str) -> list[str] | None:
    """The ``__all__`` of audiotabs_tpu/<pkg>/__init__.py, read without importing it."""
    tree = ast.parse((REPO / "audiotabs_tpu" / pkg / "__init__.py").read_text())
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(getattr(t, "id", None) == "__all__" for t in node.targets):
            return [ast.literal_eval(e) for e in node.value.elts]
    return None


def test_the_jax_subpackages_are_known():
    assert JAX_PACKAGES == ["accompaniment", "analysis", "chords", "decode", "io", "models", "ops", "parallel",
                            "runtime", "score", "tab", "theory", "train"]
    assert _jax_all("models") is None and _jax_all("train") is None  # docstrings only
    assert len(_jax_all("ops")) == 22


@pytest.mark.parametrize("pkg", [p for p in JAX_PACKAGES if _jax_all(p) is not None])
def test_every_exported_name_resolves_in_the_port(pkg):
    jax_pkg = importlib.import_module(f"audiotabs_tpu.{pkg}")
    port = importlib.import_module(f"audiotabs_tpu_torch.{pkg}")
    assert jax_pkg.__all__ == _jax_all(pkg)
    expected = [RENAMED.get((pkg, name), (name, ""))[0] for name in jax_pkg.__all__]
    assert sorted(set(expected) - set(port.__all__)) == []
    for name in expected:
        obj = getattr(port, name)
        if callable(obj):  # the port's own, not a re-export of the JAX package's
            assert obj.__module__.startswith("audiotabs_tpu_torch."), (pkg, name)


def test_runtime_and_parallel_exports():
    from audiotabs_tpu_torch.parallel import Mesh, default_mesh, make_mesh
    from audiotabs_tpu_torch.runtime import LocalStorage
    from audiotabs_tpu_torch.runtime.storage import LocalStorage as Storage

    assert LocalStorage is Storage and callable(make_mesh) and callable(default_mesh) and isinstance(Mesh, type)


@pytest.mark.parametrize("n,frame_length,hop,center", [(22050, 2048, 512, True), (22050, 2048, 512, False), (100, 2048, 512, False), (0, 1024, 256, True)])
def test_num_frames_matches_jax(n, frame_length, hop, center):
    from audiotabs_tpu.ops.spectral import num_frames as jax_num_frames
    from audiotabs_tpu_torch.ops.spectral import frame, num_frames

    assert num_frames(n, frame_length, hop, center) == jax_num_frames(n, frame_length, hop, center)
    if n >= frame_length:
        assert frame(torch.zeros(n), frame_length, hop, center=center).shape[-2] == num_frames(n, frame_length, hop, center)


@pytest.mark.parametrize("top_db", [80.0, None])
def test_magnitude_db_matches_jax(top_db):
    from audiotabs_tpu.ops import magnitude_db as jax_magnitude_db
    from audiotabs_tpu.ops import stft as jax_stft
    from audiotabs_tpu_torch.ops import magnitude_db, stft

    y = (0.3 * np.random.default_rng(0).standard_normal(22050)).astype(np.float32)
    y[5000:9000] = 0.0
    got = magnitude_db(stft(torch.from_numpy(y)), top_db=top_db).numpy()
    ref = np.asarray(jax_magnitude_db(jax_stft(jnp.asarray(y)), top_db=top_db))
    assert got.shape == ref.shape and got.dtype == ref.dtype
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-3)  # dB: 1e-3 dB is 2.3e-4 of a power ratio
    if top_db is not None:
        assert got.min() >= got.max() - top_db - 1e-4


def _click_track() -> np.ndarray:
    """tests/test_decode.py::test_beat_activation_and_estimate_beats_on_clicktrack's input."""
    sr = 22050
    y = np.zeros(int(sr * 8.0), dtype=np.float32)
    period = int(0.5 * sr)
    for i in range(0, len(y) - 400, period):
        y[i : i + 400] += np.random.default_rng(3).standard_normal(400).astype(np.float32) * np.exp(-np.arange(400) / 80.0)
    return y


def test_estimate_beats_matches_jax():
    from audiotabs_tpu.decode import estimate_beats as jax_estimate_beats
    from audiotabs_tpu_torch.decode import estimate_beats

    y = _click_track()
    tempo, beats = estimate_beats(y, 22050, device="cpu")
    ref_tempo, ref_beats = jax_estimate_beats(y, 22050)
    assert len(beats) >= 8 and beats.dtype == np.float32
    np.testing.assert_array_equal(beats, np.asarray(ref_beats))
    np.testing.assert_allclose(tempo, ref_tempo, rtol=1e-12)
    # a tensor stays on its own device
    t2, b2 = estimate_beats(torch.from_numpy(y), 22050)
    assert t2 == tempo and np.array_equal(b2, beats)


def test_estimate_beats_without_beats_gives_zero_and_empty(monkeypatch):
    """An activation too short to decode (one frame) finds no beat: (0.0, [])."""
    import audiotabs_tpu.models.beat_rnn as jax_beat_rnn
    import audiotabs_tpu_torch.models.beat_rnn as beat_rnn
    from audiotabs_tpu.decode import estimate_beats as jax_estimate_beats
    from audiotabs_tpu_torch.decode import estimate_beats

    monkeypatch.setattr(beat_rnn, "beat_activation", lambda y, sr, ensemble, fps: torch.zeros(1, device=y.device))
    monkeypatch.setattr(jax_beat_rnn, "beat_activation", lambda y, sr, fps: jnp.zeros(1))
    y = _click_track()
    tempo, beats = estimate_beats(y, 22050, device="cpu")
    ref_tempo, ref_beats = jax_estimate_beats(y, 22050)
    assert (tempo, list(beats)) == (ref_tempo, list(ref_beats)) == (0.0, [])
    assert beats.dtype == np.float32


@pytest.mark.parametrize("sr_in,sr_out", [(44100, 22050), (16000, 22050), (22050, 22050)])
def test_resample_kernel_matches_jax(sr_in, sr_out):
    from audiotabs_tpu.io.resample import _polyphase_bank as jax_bank
    from audiotabs_tpu.io.resample import resample_kernel_jax
    from audiotabs_tpu_torch.io.resample import _polyphase_bank, resample_kernel

    x = (0.5 * np.random.default_rng(sr_in).standard_normal((2, sr_in // 2))).astype(np.float32)
    got = resample_kernel(torch.from_numpy(x), sr_in, sr_out).numpy()
    ref = np.asarray(resample_kernel_jax(jnp.asarray(x), sr_in, sr_out))
    assert got.shape == ref.shape == (2, sr_out // 2)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5 * float(np.abs(ref).max()))
    if sr_in != sr_out:
        g = np.gcd(sr_in, sr_out)
        np.testing.assert_array_equal(_polyphase_bank(sr_out // g, sr_in // g), jax_bank(sr_out // g, sr_in // g))


@pytest.fixture(scope="module")
def released_state_dict():
    from audiotabs_tpu.models.torch_htdemucs import random_state_dict

    return random_state_dict(seed=0)


def test_convert_torch_state_dict_matches_jax(released_state_dict):
    from audiotabs_tpu.models.htdemucs import ALIGN
    from audiotabs_tpu.models.htdemucs import convert_torch_state_dict as jax_convert
    from audiotabs_tpu.models.htdemucs import forward as jax_forward
    from audiotabs_tpu_torch.models.htdemucs import HTDemucs, convert_torch_state_dict

    params = convert_torch_state_dict(released_state_dict)
    jparams = jax_convert(released_state_dict)
    import jax

    for got, ref in zip(jax.tree.leaves(params), jax.tree.leaves(jparams)):
        assert isinstance(got, np.ndarray) and got.dtype == ref.dtype
        np.testing.assert_array_equal(got, np.asarray(ref))
    mix = (0.1 * np.random.default_rng(0).standard_normal((2, 4 * ALIGN))).astype(np.float32)
    ref = np.asarray(jax_forward(jparams, jnp.asarray(mix)))
    with torch.inference_mode():
        out = HTDemucs.from_params(params)(torch.from_numpy(mix)).numpy()
    assert out.shape == ref.shape == (4, 2, 4 * ALIGN)
    assert float(np.abs(out - ref).max() / np.abs(ref).max()) < F32_TOL


def test_convert_torch_state_dict_prefix_and_missing_key(released_state_dict):
    from audiotabs_tpu_torch.models.htdemucs import convert_torch_state_dict

    params = convert_torch_state_dict(released_state_dict)
    bag = convert_torch_state_dict({f"models.0.{k}": v for k, v in released_state_dict.items()})
    np.testing.assert_array_equal(bag["encoder"][0]["conv_w"], params["encoder"][0]["conv_w"])
    np.testing.assert_array_equal(bag["tlayers_t"][-1]["lin2_w"], params["tlayers_t"][-1]["lin2_w"])
    with pytest.raises(KeyError, match="missing checkpoint key"):
        convert_torch_state_dict({"encoder.0.conv.weight": np.zeros((48, 4, 8, 1))})
    partial = {k: v for k, v in released_state_dict.items() if not k.startswith("crosstransformer.layers_t.4.")}
    with pytest.raises(KeyError, match="crosstransformer.layers_t.4"):
        convert_torch_state_dict(partial)


@pytest.mark.parametrize("case", ["chords", "beats only", "empty", "3/4"])
def test_export_lead_sheet_musicxml_is_byte_equal(tmp_path, case):
    from audiotabs_tpu.score.lead_sheet import export_lead_sheet_musicxml as jax_export
    from audiotabs_tpu.score.segments import Segment as JaxSegment
    from audiotabs_tpu_torch.score.lead_sheet import export_lead_sheet_musicxml
    from audiotabs_tpu_torch.score.segments import Segment

    spans = [(0.0, 2.1, "G:maj", 0.9), (2.1, 4.0, "D:maj", 0.8), (4.0, 7.3, "A:min", 0.7), (7.3, 9.0, "C:maj7", 0.6)]
    chords = [] if case in ("beats only", "empty") else spans
    beats = np.arange(0.5, 9.0, 0.5, dtype=np.float32) if case != "empty" else None
    kwargs = dict(tempo_bpm=0.0 if case == "empty" else 112.0, beat_times=beats,
                  time_signature="3/4" if case == "3/4" else "4/4", key_signature_fifths=1)
    export_lead_sheet_musicxml(tmp_path / "port.musicxml", [Segment(*c) for c in chords], **kwargs)
    jax_export(tmp_path / "jax.musicxml", [JaxSegment(*c) for c in chords], **kwargs)
    got = (tmp_path / "port.musicxml").read_bytes()
    assert got == (tmp_path / "jax.musicxml").read_bytes()
    assert b"<harmony" in got or not chords
