"""The port's htdemucs (models/htdemucs.py) against the JAX package's, on the CPU.

Tolerances, each the largest error relative to the reference's peak:

- ``_up2``/``_down2``: atol 2e-6, as tests/test_separate_program.py holds
  the JAX resamplers to the FIR they replace (measured: equal);
- ``forward`` and the separation program in float32: 1e-5 (measured about
  2e-7 on tiny weights and 7e-7 on the checkpoint; both packages share the
  STFT framing, so only the summation order of convolutions, matmuls and
  FFTs differs). tests/test_htdemucs_convert.py allows 5e-3 for a torch
  mirror with torch.stft;
- bf16 autocast against float32: an SNR of at least 30 dB on one checkpoint
  window (measured 39 dB; the JAX package's bf16 knob measured 27–51 dB).

Tiny weights are the JAX ``init_params(channels=8, bottom=64, t_layers=2)``
with the LayerScale gains (dconv ``scale``, transformer ``gamma1/2``, 1e-3
and 1e-4 at init) redrawn in [0.2, 0.8], so that every residual branch moves
the output.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import audiotabs_tpu.models.htdemucs as jhd
from audiotabs_tpu_torch.config import Settings
from audiotabs_tpu_torch.models import htdemucs
from test_torch_fused import torch_threads  # noqa: F401 (an autouse fixture)

F32_TOL = 1e-5
BF16_SNR_DB = 30.0


def _rel(got: np.ndarray, ref: np.ndarray) -> float:
    return float(np.abs(got - ref).max() / np.abs(ref).max())


def _tiny(n_sources: int) -> dict:
    params = jax.tree.map(np.asarray, jhd.init_params(jax.random.PRNGKey(0), n_sources=n_sources, channels=8, bottom=64, t_layers=2))
    rng = np.random.default_rng(n_sources)

    def redraw(node):
        if isinstance(node, list):
            return [redraw(v) for v in node]
        if isinstance(node, dict):
            return {k: rng.uniform(0.2, 0.8, v.shape).astype(np.float32) if k in ("scale", "gamma1", "gamma2") else redraw(v)
                    for k, v in node.items()}
        return node

    return redraw(params)


@pytest.fixture(scope="module")
def tiny4():
    return _tiny(4)


@pytest.fixture(scope="module")
def checkpoint():
    params = htdemucs.load_params()
    assert params is not None, "the checked-in htdemucs checkpoint is missing"
    return params


def test_up2_down2_match_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal(22050).astype(np.float32)
    up = htdemucs._up2(torch.from_numpy(x)).numpy()
    assert up.shape == (44100,)
    np.testing.assert_allclose(up, np.asarray(jhd._up2(jnp.asarray(x))), atol=2e-6)
    x2 = rng.standard_normal((3, 44100)).astype(np.float32)
    down = htdemucs._down2(torch.from_numpy(x2)).numpy()
    assert down.shape == (3, 22050)
    np.testing.assert_allclose(down, np.asarray(jhd._down2(jnp.asarray(x2))), atol=2e-6)


@pytest.mark.parametrize("n_sources", [4, 6])
def test_forward_tiny_matches_jax(n_sources):
    params = _tiny(n_sources)
    mix = (0.1 * np.random.default_rng(1).standard_normal((2, 4 * 1024))).astype(np.float32)
    mix2 = (0.3 * mix[:, ::-1]).copy()
    ref = np.asarray(jhd.forward(params, jnp.asarray(mix), n_sources=n_sources))
    ref2 = np.asarray(jhd.forward(params, jnp.asarray(mix2), n_sources=n_sources))
    net = htdemucs.HTDemucs.from_params(params)
    with torch.inference_mode():
        got = net(torch.from_numpy(mix)).numpy()
        batched = net(torch.from_numpy(np.stack([mix, mix2]))).numpy()
    assert got.shape == ref.shape == (n_sources, 2, 4 * 1024)
    assert _rel(got, ref) < F32_TOL
    # a batch is windows side by side: each is normalised by its own statistics
    assert _rel(batched[0], ref) < F32_TOL
    assert _rel(batched[1], ref2) < F32_TOL


def test_module_widths_come_from_the_checkpoint(checkpoint):
    net = htdemucs.load_model(torch.device("cpu"))
    assert net is htdemucs.load_model(torch.device("cpu"))  # built once per device
    assert [e.conv.out_channels for e in net.encoder] == [24, 48, 96, 192]
    assert (net.n_sources, net.audio_channels, net.up_s.out_features, len(net.tlayers)) == (6, 2, 192, 3)
    assert [layer.cross for layer in net.tlayers] == [True, False, True]
    assert net.tlayers[0].heads == 8 and net.tlayers[0].lin1.out_features == 768
    assert not any(p.requires_grad for p in net.parameters())


def test_forward_checkpoint_window_matches_jax(checkpoint):
    cfg = htdemucs.program_config(checkpoint, "htdemucs_6s", ["guitar"])
    mix = (0.1 * np.random.default_rng(2).standard_normal((2, cfg["seg"]))).astype(np.float32)
    run = {k: v for k, v in checkpoint.items() if k != "meta_segment"}
    ref = np.asarray(jhd.forward(run, jnp.asarray(mix), n_sources=6))
    with torch.inference_mode():
        got = htdemucs.load_model(torch.device("cpu"))(torch.from_numpy(mix)).numpy()
    assert got.shape == (6, 2, 131072)
    assert _rel(got, ref) < F32_TOL


def test_bf16_autocast_against_f32(checkpoint):
    mix = (0.1 * np.random.default_rng(3).standard_normal((2, 131072))).astype(np.float32)
    net = htdemucs.load_model(torch.device("cpu"))
    with torch.inference_mode():
        f32 = net(torch.from_numpy(mix)).numpy()
        bf16 = net(torch.from_numpy(mix), bf16=True)
    assert bf16.dtype == torch.float32
    snr = 10 * np.log10((f32**2).sum() / ((bf16.numpy() - f32) ** 2).sum())
    assert BF16_SNR_DB < snr < 100, snr  # below 100 dB: the bf16 path really ran


@pytest.mark.parametrize(
    "sr,shifts,seconds",
    [(22050, 1, 0.5), (44100, 1, 2.5), (22050, 2, 2.5), (44100, 2, 0.5)],
    ids=["22k-shifts1", "44k-shifts1-18windows", "22k-shifts2-36windows", "44k-shifts2"],
)
def test_separate_program_tiny_matches_jax(tiny4, sr, shifts, seconds):
    """seg 8192 / stride 6144 at 44.1 kHz: 2.5 s is 18 windows a shift, more
    than one chunk of _FWD_CHUNK = 16."""
    y = (0.1 * np.random.default_rng(4).standard_normal(int(sr * seconds))).astype(np.float32)
    ref = np.asarray(jhd._separate_program(tiny4, jnp.asarray(y), sr=sr, seg=8192, stride=6144, shifts=shifts, n_sources=4))
    with torch.inference_mode():
        got = htdemucs.separate_program(htdemucs.HTDemucs.from_params(tiny4), torch.from_numpy(y), sr, 8192, 6144, shifts).numpy()
    assert got.shape == ref.shape == (4, len(y))
    assert _rel(got, ref) < F32_TOL


def test_program_config_of_the_checkpoint(checkpoint):
    priority = Settings().stem_priority()
    cfg = htdemucs.program_config(checkpoint, "htdemucs_6s", priority)
    assert (cfg["seg"], cfg["stride"], cfg["n_sources"], cfg["stem_idx"], cfg["drums_idx"]) == (131072, 98304, 6, 4, 0)
    assert cfg["names"][cfg["stem_idx"]] == "guitar"
    ref = jhd.program_config(jhd.load_params(), "htdemucs_6s", priority)
    assert {k: ref[k] for k in cfg} == cfg


def test_weights_off_gives_none(monkeypatch):
    monkeypatch.setenv("HTDEMUCS_WEIGHTS", "off")
    assert htdemucs.load_params() is None
    assert htdemucs.load_model(torch.device("cpu")) is None
    assert htdemucs.separate_stems_device(torch.zeros(22050), 22050) is None


@pytest.mark.parametrize("shape,sr", [((22050,), 16000), ((2, 22050), 22050)])
def test_separate_stems_device_raises_off_the_device_path(shape, sr, tiny4, tmp_path, monkeypatch):
    """Off the device path (a 2-D signal, a rate other than 44.1 and 22.05 kHz)
    the device entry point no longer raises: it takes the host path,
    ``separate_stems``, and returns its stems as tensors on the input's
    device (held against the JAX package in tests/test_torch_hostsep.py)."""
    path = tmp_path / "tiny.npz"
    htdemucs.save_params(str(path), {**tiny4, "meta_segment": np.asarray(24576, np.int64)})
    monkeypatch.setenv("HTDEMUCS_WEIGHTS", str(path))
    y = (0.1 * np.random.default_rng(5).standard_normal(shape)).astype(np.float32)
    got = htdemucs.separate_stems_device(torch.from_numpy(y), sr)
    ref = htdemucs.separate_stems(y, sr, device="cpu")
    assert list(got) == list(ref) == ["drums", "bass", "other", "vocals"]
    for name in ref:
        assert got[name].device.type == "cpu"
        np.testing.assert_array_equal(got[name].numpy(), ref[name])
