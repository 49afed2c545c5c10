"""The port's device mesh, data-parallel batch runner and model-axis htdemucs
against the JAX package's ``parallel/``, on the CPU.

The JAX tests run on 8 virtual host devices; the port's CPU meshes are
``[torch.device("cpu")] * n`` (one process drives the mesh, as one JAX
program does).

- ``make_mesh`` / ``default_mesh``: shapes, axis names and the ValueError as
  the JAX ones; ``default_mesh`` reads ``MESH_SHAPE``/``MESH_AXES`` and
  raises without a card.
- ``model_axis_spec``: the JAX rule on every parameter shape of the tiny
  htdemucs (channels 8, bottom 64, 2 transformer layers), model sizes 1, 2, 4.
- The tiny htdemucs (JAX ``PRNGKey(0)``) with its weights sharded over a
  (4, 2) ("data", "model") mesh: at least 20 parameters distributed, each
  shard half of its parameter, the output within the JAX test's
  atol = rtol = 2e-4 of the JAX unsharded forward; and the data × model
  composition of ``tests/test_parallel.py::test_data_model_2d_composition``.
- ``batched_fused_analysis`` over an 8-way "data" mesh on the eight sines of
  ``tests/test_parallel.py`` (HPSS fallback, ``HTDEMUCS_WEIGHTS=off``)
  against the JAX 8-device run, at ``test_torch_batch_runner.py``'s
  tolerances (discrete equal, floats rtol/atol 1e-4, f16 within 2 ulps);
  B = 5 on a 4-way mesh (three zero pad rows) against the mesh-less run.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from audiotabs_tpu_torch.config import Settings
from audiotabs_tpu_torch.parallel import default_mesh, make_mesh
from audiotabs_tpu_torch.parallel.mesh import data_shards
from audiotabs_tpu_torch.parallel.model_axis import model_axis_spec, shard_params_model_axis, sharded_count, sharded_parameters
from test_torch_batch_runner import _compare
from test_torch_fused import torch_threads  # noqa: F401 (an autouse fixture)

SR = 22050
CPU8 = [torch.device("cpu")] * 8
MODEL_TOL = dict(atol=2e-4, rtol=2e-4)  # tests/test_parallel.py's


def _eight_sines() -> np.ndarray:
    """tests/test_parallel.py::test_batched_fused_analysis_8dev's batch."""
    t = np.arange(SR) / SR
    return np.stack([0.3 * np.sin(2 * np.pi * 220 * 2 ** (i / 12.0) * t) for i in range(8)]).astype(np.float32)


@pytest.fixture
def jax_env(monkeypatch):
    """Set the environment for both packages; the JAX settings are reloaded, and again after the test."""
    from audiotabs_tpu.config import reload_settings

    def set_env(**env):
        for k, v in env.items():
            monkeypatch.setenv(k, str(v))
        reload_settings()

    yield set_env
    monkeypatch.undo()
    reload_settings()


@pytest.mark.parametrize("shape,axes", [((8,), ("data",)), ((4, 2), ("data", "model")), ((2, 2, 2), ("a", "b", "c"))])
def test_make_mesh_matches_jax(shape, axes):
    from audiotabs_tpu.parallel import make_mesh as jax_make_mesh

    ref = jax_make_mesh(shape, axes)
    mesh = make_mesh(shape, axes, devices=CPU8)
    assert mesh.shape == dict(ref.shape) and mesh.axis_names == tuple(ref.axis_names)
    assert mesh.devices.shape == ref.devices.shape
    assert make_mesh(devices=CPU8[:3]).shape == {"data": 3}


@pytest.mark.parametrize("shape", [(16,), (4, 4), (3, 3)])
def test_make_mesh_raises_when_short_of_devices(shape):
    from audiotabs_tpu.parallel import make_mesh as jax_make_mesh

    with pytest.raises(ValueError, match="needs"):
        jax_make_mesh(shape, ("data",) * len(shape))
    with pytest.raises(ValueError, match="needs"):
        make_mesh(shape, ("data",) * len(shape), devices=CPU8)


def test_default_mesh_reads_the_mesh_settings(jax_env, monkeypatch):
    from audiotabs_tpu.parallel import default_mesh as jax_default_mesh

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 8)
    assert default_mesh().shape == dict(jax_default_mesh().shape) == {"data": 8}
    jax_env(MESH_SHAPE="4,2", MESH_AXES="data,model")
    mesh = default_mesh()
    assert mesh.shape == dict(jax_default_mesh().shape) == {"data": 4, "model": 2}
    assert [str(d) for d in mesh.devices.flat] == [f"cuda:{i}" for i in range(8)]
    assert mesh.axis_devices("model") == [torch.device("cuda:0"), torch.device("cuda:1")]
    assert default_mesh(Settings(MESH_SHAPE="2", MESH_AXES="data")).shape == {"data": 2}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        default_mesh()


def test_data_shards_split_rows_in_order():
    mesh = make_mesh((4, 2), ("data", "model"), devices=CPU8)
    assert [(s.start, s.stop) for _d, s in data_shards(mesh, 8)] == [(0, 2), (2, 4), (4, 6), (6, 8)]
    with pytest.raises(ValueError):
        data_shards(mesh, 6)


@pytest.fixture(scope="module")
def tiny_htdemucs():
    """The JAX test's tiny htdemucs, as numpy (init jitted: eager, every random draw compiles)."""
    import audiotabs_tpu.models.htdemucs as jhd

    params = jax.jit(lambda key: jhd.init_params(key, channels=8, bottom=64, t_layers=2))(jax.random.PRNGKey(0))
    return jax.tree.map(np.asarray, params)


@pytest.mark.parametrize("model_size", [1, 2, 4])
def test_model_axis_spec_matches_jax(tiny_htdemucs, model_size):
    from audiotabs_tpu.parallel.model_axis import model_axis_spec as jax_spec

    shapes = {tuple(leaf.shape) for leaf in jax.tree.leaves(tiny_htdemucs)}
    assert len(shapes) > 20
    for shape in sorted(shapes):
        assert model_axis_spec(shape, model_size) == tuple(jax_spec(shape, model_size)), (shape, model_size)


def _sharded_tiny(params: dict):
    """The port's tiny htdemucs sharded over a (4, 2) CPU mesh, and each parameter's full shape."""
    from audiotabs_tpu_torch.models.htdemucs import HTDemucs

    net = HTDemucs.from_params(params)
    shapes = {k: tuple(v.shape) for k, v in net.named_parameters()}
    shard_params_model_axis(net, make_mesh((4, 2), ("data", "model"), devices=CPU8))
    return net, shapes


def test_model_axis_htdemucs_forward_matches_jax(tiny_htdemucs):
    import audiotabs_tpu.models.htdemucs as jhd

    mix = np.asarray(0.1 * np.random.default_rng(0).standard_normal((2, 4096)), np.float32)
    ref = np.asarray(jhd.forward(tiny_htdemucs, jnp.asarray(mix)))
    net, shapes = _sharded_tiny(tiny_htdemucs)
    shards = sharded_parameters(net)
    assert sharded_count(net) == len(shards) >= 20
    # exactly the parameters with a spec are distributed, each half on each model device
    assert set(shards) == {name for name, shape in shapes.items() if model_axis_spec(shape, 2)}
    for name, parts in shards.items():
        assert len(parts) == 2 and all(2 * p.numel() == int(np.prod(shapes[name])) for p in parts), name
    with torch.inference_mode():
        out = net(torch.from_numpy(mix)).numpy()
    np.testing.assert_allclose(out, ref, **MODEL_TOL)


def test_data_model_2d_composition(tiny_htdemucs):
    import audiotabs_tpu.models.htdemucs as jhd

    batch = np.asarray(0.1 * np.random.default_rng(1).standard_normal((8, 2, 4096)), np.float32)
    ref = np.asarray(jax.vmap(lambda m: jhd.forward(tiny_htdemucs, m))(jnp.asarray(batch)))
    net, _ = _sharded_tiny(tiny_htdemucs)
    assert sharded_count(net) >= 20
    mesh = make_mesh((4, 2), ("data", "model"), devices=CPU8)
    with torch.inference_mode():
        out = np.concatenate([net(torch.from_numpy(batch[rows]).to(dev)).numpy() for dev, rows in data_shards(mesh, 8)])
    np.testing.assert_allclose(out, ref, **MODEL_TOL)


def test_batched_fused_analysis_8way_matches_jax(jax_env):
    from audiotabs_tpu.parallel import make_mesh as jax_make_mesh
    from audiotabs_tpu.runtime.batch_runner import batched_fused_analysis as jax_batched
    from audiotabs_tpu_torch.runtime.batch_runner import batched_fused_analysis

    jax_env(HTDEMUCS_WEIGHTS="off")
    batch = _eight_sines()
    got = batched_fused_analysis(batch, SR, mesh=make_mesh((8,), ("data",), devices=CPU8), settings=Settings())
    ref = jax_batched(batch, SR, mesh=jax_make_mesh((8,), ("data",)))
    assert got["chord_emissions"].shape[0] == 8
    np.testing.assert_allclose(got["chord_emissions"].sum(axis=1), 1.0, atol=1e-3)
    _compare(ref, got, dict(rtol=1e-4, atol=1e-4), "8-way mesh, port vs jax")


def test_pad_rows_are_cropped(monkeypatch):
    from audiotabs_tpu_torch.runtime.batch_runner import batched_fused_analysis, batched_fused_analysis_stream

    monkeypatch.setenv("HTDEMUCS_WEIGHTS", "off")
    batch = _eight_sines()[:5]
    lens = np.array([SR, SR - 2000, SR, SR // 2, SR], np.int32)
    mesh = make_mesh((4,), ("data",), devices=CPU8[:4])
    chunks = list(batched_fused_analysis_stream(batch, SR, lens, mesh=mesh, settings=Settings()))
    assert [a for a, _ in chunks] == [0] and chunks[0][1]["chord_emissions"].shape[0] == 5
    ref = batched_fused_analysis(batch, SR, lens, device="cpu", settings=Settings())
    _compare(ref, chunks[0][1], dict(rtol=1e-4, atol=1e-6), "4-way mesh with 3 pad rows vs no mesh")
    # two songs per device per chunk: chunks of 8 rows over the 4 devices, the tail padded
    small = list(batched_fused_analysis_stream(batch, SR, lens, mesh=mesh, settings=Settings(BATCH_SONGS_PER_DEVICE=1)))
    assert [(a, h["crf_path"].shape[0]) for a, h in small] == [(0, 4), (4, 1)]
    _compare(ref, {k: np.concatenate([h[k] for _, h in small]) for k in ref}, dict(rtol=1e-4, atol=1e-6), "chunks of 4")


def test_mesh_and_device_are_exclusive():
    from audiotabs_tpu_torch.runtime.batch_runner import batched_fused_analysis

    with pytest.raises(ValueError, match="not both"):
        batched_fused_analysis(_eight_sines()[:1], SR, mesh=make_mesh((1,), devices=CPU8[:1]), device="cpu")
