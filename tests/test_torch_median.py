"""The port's median filter and HPSS masks against the JAX package.

The plain version (what a CPU tensor takes) must equal the JAX XLA median
and the Pallas kernel in interpret mode exactly: a median selects an input
element. The selection networks the CUDA kernel runs are generated by
``median_schedule``; here they are interpreted with torch min/max over the
kernel's own segmentation and clamped loads, proved on every 0/1 input where
that is feasible, and held against the plain version. The CUDA kernel itself
is held against the plain version on the card by chip_smoke.py, and by the
``cuda``-marked test here.
"""

import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from audiotabs_tpu.ops.hpss import _median_filter_lastaxis
from audiotabs_tpu.ops.hpss import hpss_masks as jax_hpss_masks
from audiotabs_tpu.ops.pallas_median import median_filter_lastaxis_pallas
from audiotabs_tpu_torch import _build, tracing
from audiotabs_tpu_torch.ops import median as tmed
from audiotabs_tpu_torch.ops.hpss import hpss_masks


def _jax_median(x: np.ndarray, win: int, axis: int) -> np.ndarray:
    if axis == -1:
        return np.asarray(_median_filter_lastaxis(jnp.asarray(x), win))
    return np.swapaxes(np.asarray(_median_filter_lastaxis(jnp.swapaxes(jnp.asarray(x), -1, -2), win)), -1, -2)


def _pallas_median(x: np.ndarray, win: int, axis: int) -> np.ndarray:
    def one(s):  # [F, T]
        if axis == -1:
            return median_filter_lastaxis_pallas(s, win, interpret=True)
        return median_filter_lastaxis_pallas(s.T, win, interpret=True).T

    xj = jnp.asarray(x)
    return np.asarray(jax.vmap(one)(xj) if x.ndim == 3 else one(xj))


@pytest.mark.parametrize("win", [5, 17, 31])
@pytest.mark.parametrize("axis", [-1, -2])
@pytest.mark.parametrize("shape", [(40, 70), (2, 37, 45)])
def test_plain_median_matches_jax_exactly(win, axis, shape):
    rng = np.random.default_rng(win + 10 * len(shape))
    x = np.abs(rng.standard_normal(shape)).astype(np.float32)
    got = tmed.median_filter(torch.from_numpy(x), win, axis).numpy()
    np.testing.assert_array_equal(got, _jax_median(x, win, axis))


@pytest.mark.parametrize("win,axis,shape", [(31, -1, (20, 150)), (17, -2, (40, 60)), (5, -1, (2, 12, 40))])
def test_plain_median_matches_pallas_interpret_exactly(win, axis, shape):
    rng = np.random.default_rng(win)
    x = np.abs(rng.standard_normal(shape)).astype(np.float32)
    got = tmed.median_filter(torch.from_numpy(x), win, axis).numpy()
    np.testing.assert_array_equal(got, _pallas_median(x, win, axis))


def test_median_cpu_tensor_takes_plain_version_without_counting():
    x = torch.rand(8, 20)
    before = tracing.counters().get("median_filter_launches", 0)
    torch.testing.assert_close(tmed.median_filter(x, 5), tmed.median_filter_plain(x, 5), rtol=0, atol=0)
    assert tracing.counters().get("median_filter_launches", 0) == before


@pytest.mark.parametrize(
    "x,win,axis,err",
    [
        (torch.rand(8, 20), 4, -1, ValueError),  # even window
        (torch.rand(8, 20), 129, -1, ValueError),  # window too wide
        (torch.rand(8, 20, dtype=torch.float64), 5, -1, TypeError),
        (torch.rand(20), 5, -1, ValueError),  # 1-D
        (torch.rand(2, 3, 8, 20), 5, -1, ValueError),  # 4-D
        (torch.rand(2, 8, 20), 5, 0, ValueError),  # batch axis
        (torch.rand(8, 20, device="meta"), 5, -1, ValueError),  # neither cuda nor cpu
    ],
)
def test_median_rejects_bad_arguments(x, win, axis, err):
    with pytest.raises(err):
        tmed.median_filter(x, win, axis)


@pytest.mark.parametrize("kernels", [(31, 31), (17, 17)])
def test_hpss_masks_match_jax(kernels):
    rng = np.random.default_rng(3)
    S = np.abs(rng.standard_normal((64, 120))).astype(np.float32)
    S[:, 5] = 0.0  # a silent frame exercises the 0.5 fallback
    mh_ref, mp_ref = (np.asarray(m) for m in jax_hpss_masks(jnp.asarray(S), *kernels, use_pallas=False))
    mh, mp = (m.numpy() for m in hpss_masks(torch.from_numpy(S), *kernels))
    np.testing.assert_allclose(mh, mh_ref, rtol=0, atol=1e-6)
    np.testing.assert_allclose(mp, mp_ref, rtol=0, atol=1e-6)


def _by_schedule(x: torch.Tensor, win: int, axis: int) -> torch.Tensor:
    """What the kernel computes: segments of k outputs along the axis, each
    from win+k-1 loads at clamped (edge-replicated) indices through the
    generated network; outputs past the end are not stored."""
    k = tmed.NET_OUTPUTS[win]
    xt = x if axis == -1 else x.transpose(-1, -2)
    n = xt.shape[-1]
    segs = -(-n // k)
    pos = torch.arange(segs)[:, None] * k - win // 2 + torch.arange(win + k - 1)[None]
    vals = xt[..., pos.clamp(0, n - 1)]  # [..., segs, win + k - 1]
    outs = tmed.median_schedule(win, k).run(list(vals.unbind(-1)))
    y = torch.stack(outs, -1).reshape(*xt.shape[:-1], segs * k)[..., :n]
    return y if axis == -1 else y.transpose(-1, -2)


def _tie_heavy(rng, shape) -> np.ndarray:
    """Four levels, and runs of zeros along both axes."""
    x = rng.integers(0, 4, shape).astype(np.float32) / 4
    x[..., rng.random(shape[-1]) < 0.3] = 0.0
    x[..., rng.random(shape[-2]) < 0.3, :] = 0.0
    return x


# every 0/1 input is 2**(win+k-1) of them: the kernel's networks up to 24 inputs
_PROVED = sorted({(5, 3), (9, 4), (17, 4)} | {(w, k) for w, k in tmed.NET_OUTPUTS.items() if w + k - 1 <= 24})


def test_the_kernel_networks_of_windows_5_and_17_are_proved():
    assert {(5, tmed.NET_OUTPUTS[5]), (17, tmed.NET_OUTPUTS[17])} <= set(_PROVED)


@pytest.mark.parametrize("win,k", _PROVED)
def test_schedule_is_right_on_every_0_1_input(win, k):
    # min/max circuits commute with monotone maps, so right on all 0/1 inputs
    # means right on all inputs (the 0-1 principle). Inputs are bit-packed:
    # on 0/1 values min is AND and max is OR.
    n = win + k - 1
    m = np.arange(1 << n, dtype=np.uint32)

    def bit(i):  # input i of every assignment m
        return ((m >> i) & 1).astype(np.uint8)

    packed = [torch.from_numpy(np.packbits(bit(i))) for i in range(n)]
    got = tmed.median_schedule(win, k).run(packed, torch.bitwise_and, torch.bitwise_or)
    count = np.zeros(1 << n, np.uint8)  # ones in window j
    for i in range(win):
        count += bit(i)
    for j in range(k):
        if j:
            count += bit(j + win - 1)
            count -= bit(j - 1)
        assert torch.equal(got[j], torch.from_numpy(np.packbits(count > win // 2))), f"output {j}"


@pytest.mark.parametrize("win", sorted(tmed.NET_OUTPUTS))
@pytest.mark.parametrize("axis", [-1, -2])
@pytest.mark.parametrize("kind", ["float", "zero_one", "tie_heavy"])
def test_schedule_equals_plain_version(win, axis, kind):
    rng = np.random.default_rng(win * 10 + (axis == -1))
    shape = (3, 45, 61)  # neither extent a multiple of the segment
    x = {
        "float": np.abs(rng.standard_normal(shape)).astype(np.float32),
        "zero_one": rng.integers(0, 2, shape).astype(np.float32),
        "tie_heavy": _tie_heavy(rng, shape),
    }[kind]
    xt = torch.from_numpy(x)
    assert torch.equal(_by_schedule(xt, win, axis), tmed.median_filter_plain(xt, win, axis))


@pytest.mark.parametrize("win", sorted(tmed.NET_OUTPUTS))
@pytest.mark.parametrize("shape", [(1, 1), (1, 3), (1, 13), (2, 30), (3, 1), (13, 2), (2, 5, 37)])
def test_schedule_equals_plain_version_on_short_and_ragged_extents(win, shape):
    x = torch.from_numpy(_tie_heavy(np.random.default_rng(win), shape))
    for axis in (-1, -2):
        assert torch.equal(_by_schedule(x, win, axis), tmed.median_filter_plain(x, win, axis)), axis


def test_schedule_min_max_per_output():
    counts = {w: tmed.median_schedule(w, k).ops_per_output for w, k in tmed.NET_OUTPUTS.items()}
    assert counts[31] <= 110 and counts[17] <= 60, counts  # the odd-even sort: 930 and 272
    assert counts == {5: 6.0, 17: 22.0, 31: 32.375}
    for w, k in tmed.NET_OUTPUTS.items():
        s = tmed.median_schedule(w, k)
        assert s.n_regs <= 96 and len(set(s.outputs)) == k


@pytest.mark.parametrize("win,k", [(4, 1), (5, 0), (5, 4), (31, 17)])
def test_schedule_rejects_even_windows_and_too_many_outputs(win, k):
    with pytest.raises(ValueError):
        tmed.median_schedule(win, k)


def test_header_is_the_interpreted_schedule():
    header = tmed.schedule_header()
    assert re.search(r"#define MEDIAN_NET_WINDOWS\(X\) X\(5\) X\(17\) X\(31\)", header)
    for win, k in tmed.NET_OUTPUTS.items():
        s = tmed.median_schedule(win, k)
        body = header.split(f"struct MedianNet<{win}> {{")[1].split("};")[0]
        assert f"kOutputs = {k};" in body and f"kRegs = {s.n_regs};" in body
        ops = [(kind, int(d), int(a), int(b)) for d, kind, a, b in re.findall(r"r\[(\d+)\] = f(min|max)f\(r\[(\d+)\], r\[(\d+)\]\);", body)]
        assert ops == list(s.ops)
        assert [int(o) for o in re.findall(r"m\[\d+\] = r\[(\d+)\];", body)] == list(s.outputs)


def test_library_hash_covers_the_generated_header():
    a = _build.library_path("median_filter", tmed._headers())
    b = _build.library_path("median_filter", {"median_schedule.h": tmed.schedule_header() + "// edited\n"})
    assert a != b and a == _build.library_path("median_filter", tmed._headers())


def test_ptxas_usage_reads_registers_and_spills(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    report = (
        "ptxas info    : 0 bytes gmem\n"
        "ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_117median_net_kernelILi31ELb1EEEvPKfPfiii' for 'sm_90a'\n"
        "ptxas info    : Function properties for _ZN12_GLOBAL__N_117median_net_kernelILi31ELb1EEEvPKfPfiii\n"
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
        "ptxas info    : Used 56 registers, used 1 barriers, 380 bytes cmem[0]\n"
        "ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_118median_rank_kernelILb0EEEvPKfPfiiii' for 'sm_90a'\n"
        "ptxas info    : Function properties for _ZN12_GLOBAL__N_118median_rank_kernelILb0EEEvPKfPfiiii\n"
        "    8 bytes stack frame, 4 bytes spill stores, 8 bytes spill loads\n"
        "ptxas info    : Used 30 registers, used 1 barriers, 384 bytes cmem[0]\n"
    )
    _build.library_path("median_filter", {}).with_suffix(".ptxas.txt").write_text(report)
    usage = sorted(_build.ptxas_usage("median_filter", {}).items())
    assert [u for _, u in usage] == [
        {"spill_stores": 0, "spill_loads": 0, "registers": 56},
        {"spill_stores": 4, "spill_loads": 8, "registers": 30},
    ]
    assert "median_net_kernel" in usage[0][0] and "median_rank_kernel" in usage[1][0]


@pytest.mark.cuda
@pytest.mark.parametrize(
    "shape,win",
    [((1025, 1292), 31), ((513, 1292), 17), ((20, 513, 130), 17), ((2, 1025, 1292), 31), ((3, 37, 70), 7),
     ((2, 45, 61), 5), ((1, 3), 31), ((13, 2), 17)],
)
def test_cuda_kernel_equals_plain_version(shape, win):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the median kernel has no CPU mode")
    rng = np.random.default_rng(0)
    x = torch.from_numpy(np.abs(rng.standard_normal(shape)).astype(np.float32)).cuda()
    for axis in (-1, -2):
        before = tracing.counters().get("median_filter_launches", 0)
        got = tmed.median_filter(x, win, axis)
        torch.cuda.synchronize()
        assert tracing.counters()["median_filter_launches"] == before + 1
        assert torch.equal(got, tmed.median_filter_plain(x, win, axis))
