"""The port's htdemucs (models/htdemucs.py) in the published layer order,
against the plain reference ``benchmarks/own_reference/htdemucs_published.py``
on the CPU.

Published htdemucs (demucs' ``CrossTransformerEncoder`` with
``t_cross_first=False``) self-attends at layers 0, 2 and 4 and cross-attends
at 1 and 3; the port reads each layer's kind from its parameters. The
weights are the reference's own seeded ``init_params`` at channels 8, bottom
64, 5 layers in the published order, 6 sources and the transformer's
LayerScale at 0.1 (the ``shipped`` configuration's order and LayerScale, at
a size the CPU holds), read by both sides.

Tolerance ``F32_TOL``: the largest error relative to the reference's peak,
1e-5. Both sides compute the same float32 arithmetic on the same weights;
only the summation order of convolutions, matrix products and FFTs may
differ (measured: 0 on the forward and every separation case, 1.7e-7
through the state-dict converter, which divides the frequency embedding by
its scale of 10 and multiplies it again). It is the bound that
tests/test_torch_htdemucs.py holds the port to the JAX package with.

``MISS`` = 100 × ``F32_TOL``: the same weights run in the old order (a
``norm3`` of ones and zeros, the unit norm of the init, given to layers 0, 2
and 4 and taken from 1 and 3) or with every attention branch zeroed
(``gamma1`` = 0) must miss the reference by at least that much (measured:
4.5e-2 and 3.5e-2).
"""

from __future__ import annotations

import importlib.util
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from audiotabs_tpu_torch import tracing
from audiotabs_tpu_torch.models import htdemucs
from test_torch_fused import torch_threads  # noqa: F401 (an autouse fixture)

BENCH = Path(__file__).resolve().parents[1] / "benchmarks"
F32_TOL = 1e-5
MISS = 100 * F32_TOL
SMALL = {"n_sources": 6, "audio_channels": 2, "channels": 8, "bottom": 64, "t_layers": 5, "layer_scale": 0.1}
PUBLISHED_CROSS = [False, True, False, True, False]


def _rel(got, ref) -> float:
    got, ref = np.asarray(got), np.asarray(ref)
    return float(np.abs(got - ref).max() / np.abs(ref).max())


@pytest.fixture(scope="module")
def published():
    """The reference module, loaded by path beside the shared reference it imports from."""
    if str(BENCH) not in sys.path:
        sys.path.append(str(BENCH))
    import reference.models  # noqa: F401 (the package its relative imports resolve in)

    name = "reference.models.htdemucs_published"
    if name not in sys.modules:
        spec = importlib.util.spec_from_file_location(name, BENCH / "own_reference" / "htdemucs_published.py")
        module = importlib.util.module_from_spec(spec)
        sys.modules[name] = module
        spec.loader.exec_module(module)
    return sys.modules[name]


@pytest.fixture(scope="module")
def params(published):
    return published.init_params(torch.Generator().manual_seed(2211085530), **SMALL)


@pytest.fixture(scope="module")
def windows():
    rng = np.random.default_rng(7)
    return torch.from_numpy((0.1 * rng.standard_normal((2, 2, 4 * htdemucs.ALIGN))).astype(np.float32))


def _forward(module, p: dict, x: torch.Tensor) -> np.ndarray:
    with torch.inference_mode():
        return module.HTDemucs.from_params(p)(x).numpy()


def old_order(p: dict) -> dict:
    """``p`` with cross-attention at the even layers and self-attention at the odd ones."""
    def flip(i: int, layer: dict) -> dict:
        layer = {k: v for k, v in layer.items() if k not in ("norm3_g", "norm3_b")}
        if i % 2 == 0:
            layer["norm3_g"], layer["norm3_b"] = np.ones_like(layer["norm1_g"]), np.zeros_like(layer["norm1_b"])
        return layer

    return {**p, **{b: [flip(i, layer) for i, layer in enumerate(p[b])] for b in ("tlayers", "tlayers_t")}}


def no_attention(p: dict) -> dict:
    """``p`` with every attention branch's LayerScale at 0."""
    return {**p, **{b: [{**layer, "gamma1": np.zeros_like(layer["gamma1"])} for layer in p[b]]
                    for b in ("tlayers", "tlayers_t")}}


def published_state_dict(p: dict) -> dict[str, np.ndarray]:
    """``p`` as a released demucs HTDemucs state dict: demucs' key names, its
    Conv1d 1×1 and ``in_proj`` layouts and the frequency embedding over its
    scale of 10; a layer cross-attends (``cross_attn``, ``norm3``) where its
    pytree has ``norm3_g``, else it self-attends (``self_attn``)."""
    sd: dict[str, np.ndarray] = {}
    for ours in ("encoder", "tencoder"):
        for i, layer in enumerate(p[ours]):
            for n in ("conv", "rewrite"):
                sd[f"{ours}.{i}.{n}.weight"], sd[f"{ours}.{i}.{n}.bias"] = layer[f"{n}_w"], layer[f"{n}_b"]
            for j, blk in enumerate(layer["dconv"]["blocks"]):
                b = f"{ours}.{i}.dconv.layers.{j}"
                for k, n in (("0", "conv1"), ("1", "gn1"), ("3", "conv2"), ("4", "gn2")):
                    tail = ("_w", "_b") if n.startswith("conv") else ("_g", "_b")
                    sd[f"{b}.{k}.weight"], sd[f"{b}.{k}.bias"] = blk[n + tail[0]], blk[n + tail[1]]
                sd[f"{b}.6.scale"] = blk["scale"]
    for ours in ("decoder", "tdecoder"):
        for i, layer in enumerate(p[ours]):
            sd[f"{ours}.{i}.rewrite.weight"], sd[f"{ours}.{i}.rewrite.bias"] = layer["rewrite_w"], layer["rewrite_b"]
            sd[f"{ours}.{i}.conv_tr.weight"], sd[f"{ours}.{i}.conv_tr.bias"] = layer["convtr_w"], layer["convtr_b"]
    sd["freq_emb.embedding.weight"] = p["freq_emb"] / np.float32(10.0)
    for ours, theirs in (("up_s", "channel_upsampler"), ("up_t", "channel_upsampler_t"),
                         ("down_s", "channel_downsampler"), ("down_t", "channel_downsampler_t")):
        sd[f"{theirs}.weight"], sd[f"{theirs}.bias"] = p[f"{ours}_w"][:, :, None], p[f"{ours}_b"]
    for n in ("norm_in", "norm_in_t"):
        sd[f"crosstransformer.{n}.weight"], sd[f"crosstransformer.{n}.bias"] = p[f"{n}_g"], p[f"{n}_b"]
    for ours, theirs in (("tlayers", "layers"), ("tlayers_t", "layers_t")):
        for i, lp in enumerate(p[ours]):
            pre = f"crosstransformer.{theirs}.{i}"
            attn = "cross_attn" if "norm3_g" in lp else "self_attn"
            sd[f"{pre}.{attn}.in_proj_weight"] = np.concatenate([lp["q_w"].T, lp["k_w"].T, lp["v_w"].T])
            sd[f"{pre}.{attn}.in_proj_bias"] = np.concatenate([lp["q_b"], lp["k_b"], lp["v_b"]])
            sd[f"{pre}.{attn}.out_proj.weight"], sd[f"{pre}.{attn}.out_proj.bias"] = lp["o_w"].T, lp["o_b"]
            norms = ("norm1", "norm2", "norm3") if "norm3_g" in lp else ("norm1", "norm2")
            for n in norms:
                sd[f"{pre}.{n}.weight"], sd[f"{pre}.{n}.bias"] = lp[f"{n}_g"], lp[f"{n}_b"]
            sd[f"{pre}.norm_out.weight"], sd[f"{pre}.norm_out.bias"] = lp["normout_g"], lp["normout_b"]
            sd[f"{pre}.linear1.weight"], sd[f"{pre}.linear1.bias"] = lp["lin1_w"].T, lp["lin1_b"]
            sd[f"{pre}.linear2.weight"], sd[f"{pre}.linear2.bias"] = lp["lin2_w"].T, lp["lin2_b"]
            sd[f"{pre}.gamma_1.scale"], sd[f"{pre}.gamma_2.scale"] = lp["gamma1"], lp["gamma2"]
    return {k: np.ascontiguousarray(v) for k, v in sd.items()}


def _port_init(g: torch.Generator) -> dict:
    return htdemucs.init_params(g, n_sources=6, channels=8, bottom=64, t_layers=5)


@pytest.mark.parametrize("init,kinds", [("published", PUBLISHED_CROSS), ("port", [not c for c in PUBLISHED_CROSS])],
                         ids=["published", "jax-order"])
def test_init_params_makes_either_order_and_the_module_reads_it(published, init, kinds):
    """The reference's ``init_params`` makes the published order, the port's
    the JAX package's (cross-attention at the even layers); each net builds
    each layer's kind from the parameters, in both branches, whichever init
    made them."""
    g = torch.Generator().manual_seed(0)
    p = published.init_params(g, **SMALL) if init == "published" else _port_init(g)
    for branch in ("tlayers", "tlayers_t"):
        assert ["norm3_g" in layer for layer in p[branch]] == kinds
    for module in (htdemucs, published):
        net = module.HTDemucs.from_params(p)
        assert [layer.cross for layer in net.tlayers] == [layer.cross for layer in net.tlayers_t] == kinds
    if init == "published":
        assert float(p["tlayers"][0]["gamma1"][0]) == pytest.approx(0.1)


def test_forward_matches_the_published_reference(published, params, windows):
    ref = _forward(published, params, windows)
    got = _forward(htdemucs, params, windows)
    assert got.shape == ref.shape == (2, 6, 2, 4 * htdemucs.ALIGN)
    assert _rel(got, ref) < F32_TOL


@pytest.mark.parametrize("altered", [old_order, no_attention], ids=["old-order", "no-attention"])
def test_the_same_weights_altered_miss_the_reference(published, params, windows, altered):
    ref = _forward(published, params, windows)
    assert _rel(_forward(htdemucs, altered(params), windows), ref) > MISS
    assert _rel(_forward(published, altered(params), windows), ref) > MISS


@pytest.mark.parametrize("sr", [22050, 44100])
@pytest.mark.parametrize("shifts", [1, 2])
def test_separate_program_matches_the_published_reference(published, params, sr, shifts):
    """A 3 s song, seg 8192 / stride 6144 at 44.1 kHz: 22 windows a shift,
    more than one chunk of ``_FWD_CHUNK`` = 16."""
    y = torch.from_numpy((0.1 * np.random.default_rng(sr + shifts).standard_normal(3 * sr)).astype(np.float32))
    with torch.inference_mode():
        ref = published.separate_program(published.HTDemucs.from_params(params), y, sr, 8192, 6144, shifts).numpy()
        got = htdemucs.separate_program(htdemucs.HTDemucs.from_params(params), y, sr, 8192, 6144, shifts).numpy()
    assert got.shape == ref.shape == (6, len(y))
    assert _rel(got, ref) < F32_TOL


def test_a_published_state_dict_converts_and_matches_the_reference(published, params, windows):
    from audiotabs_tpu.models.torch_htdemucs import random_state_dict

    sd = published_state_dict(params)
    assert "crosstransformer.layers.0.self_attn.in_proj_weight" in sd and "crosstransformer.layers.0.norm3.weight" not in sd
    assert "crosstransformer.layers_t.1.cross_attn.in_proj_weight" in sd and "crosstransformer.layers_t.1.norm3.weight" in sd
    # the key names are demucs' own, as the JAX package's torch mirror of HTDemucs has them (cross at its even layers)
    mirror = random_state_dict(seed=0)

    def kinds(keys, cross_at: int) -> set[str]:
        return {k.replace(f"layers.{i}.", f"layers.{'cross' if i % 2 == cross_at else 'self'}.")
                 .replace(f"layers_t.{i}.", f"layers_t.{'cross' if i % 2 == cross_at else 'self'}.")
                for k in keys if k.startswith("crosstransformer.layers") for i in [int(k.split(".")[2])]} | {
            k for k in keys if not k.startswith("crosstransformer.layers")}

    assert kinds(sd, 1) == kinds(mirror, 0)

    converted = htdemucs.convert_torch_state_dict({f"models.0.{k}": v for k, v in sd.items()})
    for branch in ("tlayers", "tlayers_t"):
        assert ["norm3_g" in layer for layer in converted[branch]] == PUBLISHED_CROSS
    assert _rel(_forward(htdemucs, converted, windows), _forward(published, params, windows)) < F32_TOL
    partial = {k: v for k, v in sd.items() if not k.startswith("crosstransformer.layers.3.cross_attn.")}
    with pytest.raises(KeyError, match="crosstransformer.layers.3.self_attn.in_proj_weight"):
        htdemucs.convert_torch_state_dict(partial)


def test_separation_counts_its_windows_and_chunks_and_keeps_its_spans(params):
    """2.5 s at 44.1 kHz, seg 8192 / stride 6144, 2 shifts: 18 windows
    unshifted and 20 shifted by 0.25 s, 38 in 3 forward calls of at most 16."""
    y = torch.from_numpy((0.1 * np.random.default_rng(3).standard_normal(110250)).astype(np.float32))
    net = htdemucs.HTDemucs.from_params(params)
    counts_before, total_before = tracing.recorded()[1], tracing.counters()
    t0 = time.perf_counter_ns()
    with profile(activities=[ProfilerActivity.CPU]), torch.inference_mode():
        htdemucs.separate_program(net, y, 44100, 8192, 6144, 2)
    spans, counts = tracing.recorded()
    total = tracing.counters()
    for name, n in (("separation_windows", 38), ("separation_chunks", 3)):
        assert counts.get(name, 0) - counts_before.get(name, 0) == n
        assert total.get(name, 0) - total_before.get(name, 0) == n
    kept = [s for s in spans if s.start_ns >= t0]
    names = [s.name for s in kept]
    assert {n: names.count(n) for n in set(names)} == {"separation/windows": 1, "separation/net": 3,
                                                       "separation/transformer": 3, "separation/overlap_add": 1}
    assert all(s.parent.name == "separation/net" for s in kept if s.name == "separation/transformer")
