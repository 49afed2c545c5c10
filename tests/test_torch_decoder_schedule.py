"""The decoder kernels' partitioned first-maximum reductions, emulated with torch.

csrc/dbn_viterbi.cu and csrc/banded_viterbi.cu split each argmax over a
group of lanes: every lane scans its own ascending candidates with a strict
>, starting from (-inf, its first index), and the group then combines
(value, index) pairs by xor shuffles, the larger value winning and the lower
index a tie. The DBN's forward pass takes only the maximum entering each
phase 0 (each of kLanes lanes over a run of S of the 84 source tempi, padded
to S kLanes with -inf, then the group); its backtrack recomputes the first
maximum at each beat with the 32 lanes of a warp, lane i taking the sources
i, i + 32, ...; the banded Viterbi's forward pass takes only the maximum
(lane q of kLanes over the offsets q C .. q C + C - 1 of the 2 band + 1
candidates, bins outside the range -inf), and its backtrack the lowest
offset whose sum equals it, 32 offsets to a ballot; the DBN's final argmax over [n, P] gives each lane R phases of one
tempo (-1e30 past the tempo's interval), then reduces over the warp and
over the warps. Here the same partitions and the same shuffle trees run on
tie-heavy inputs (all-equal rows, two-level rows, -1e30 padding) and must
give torch.argmax's and jnp.argmax's first maximum and its value. The
partition constants are read from the CUDA sources, so the emulation
follows the kernels. The kernels themselves are held against the plain
loops on the card (chip_smoke.py, tests/test_torch_decoder_kernels.py).
"""

from __future__ import annotations

import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from audiotabs_tpu_torch import _build
from audiotabs_tpu_torch.decode import dbn_beats as tdbn

NEG = -1e30
BIG = 2**31 - 1  # INT_MAX: the index a lane with no candidate starts from
KINDS = ["random", "all equal", "two levels", "-1e30 padding"]


def _source(name: str) -> str:
    return (_build.PACKAGE_DIR / "csrc" / f"{name}.cu").read_text()


def _dbn_layout() -> tuple[int, int, int]:
    """(kLanes, R, S) of the layout the shipped tempo grid takes, read from the source."""
    text = _source("dbn_viterbi")
    lanes = int(re.search(r"constexpr int kLanes = (\d+);", text).group(1))
    r, s = map(int, re.search(r"return launch<(\d+), (\d+), false>", text).groups())
    return lanes, r, s


def _banded_layout() -> tuple[int, int, int]:
    """(kLanes, kBins, kMaxBins) of the banded kernel, read from the source."""
    text = _source("banded_viterbi")
    return tuple(int(re.search(rf"constexpr int {name} = (\d+);", text).group(1)) for name in ("kLanes", "kBins", "kMaxBins"))


def _xor_tree(v: torch.Tensor, i: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The shuffle tree over the last axis (a power of two): at each step every
    lane takes its xor partner's pair when that value is larger, or equal
    with a lower index. Every lane ends with the same pair."""
    lanes = v.shape[-1]
    off = lanes // 2
    while off:
        partner = torch.arange(lanes) ^ off
        pv, pi = v[..., partner], i[..., partner]
        take = (pv > v) | ((pv == v) & (pi < i))
        v, i = torch.where(take, pv, v), torch.where(take, pi, i)
        off //= 2
    assert (v == v[..., :1]).all() and (i == i[..., :1]).all()
    return v[..., 0], i[..., 0]


def _lane_scans(cand: torch.Tensor, runs: list[list[int]], start: list[int]) -> tuple[torch.Tensor, torch.Tensor]:
    """Each lane's ascending scan with a strict > over cand[..., run] (an
    index past the last candidate is -inf), from (-inf, start): [..., lanes]."""
    n = cand.shape[-1]
    vals, idxs = [], []
    for run, first in zip(runs, start):
        bv = torch.full(cand.shape[:-1], -float("inf"))
        bi = torch.full(cand.shape[:-1], first, dtype=torch.int64)
        for k in run:
            v = cand[..., k] if k < n else torch.full_like(bv, -float("inf"))
            take = v > bv
            bv, bi = torch.where(take, v, bv), torch.where(take, torch.full_like(bi, k), bi)
        vals.append(bv)
        idxs.append(bi)
    return torch.stack(vals, -1), torch.stack(idxs, -1)


def _values(kind: str, shape: tuple, rng) -> np.ndarray:
    if kind == "random":
        return (-50.0 * rng.random(shape)).astype(np.float32)
    if kind == "all equal":
        return np.full(shape, -7.25, np.float32)
    if kind == "two levels":
        return np.where(rng.random(shape) < 0.5, -3.0, -4.5).astype(np.float32)
    x = np.where(rng.random(shape) < 0.7, NEG, -2.0).astype(np.float32)  # mostly -1e30, and rows of it only
    x[..., ::5, :] = NEG
    return x


def _check(v: torch.Tensor, i: torch.Tensor, cand: np.ndarray) -> None:
    ref = torch.argmax(torch.from_numpy(cand), dim=-1)
    assert torch.equal(i, ref)
    np.testing.assert_array_equal(i.numpy(), np.asarray(jnp.argmax(jnp.asarray(cand), axis=-1)))
    assert torch.equal(v, torch.from_numpy(cand).max(dim=-1).values)


@pytest.mark.parametrize("kind", KINDS)
def test_dbn_transition_max_by_lanes_is_the_first_maximum(kind):
    # [84 to x 84 from]: the score at each source's last phase plus the
    # transition matrix; the forward pass's maximum over kLanes runs of S,
    # the backtrack's first maximum over a warp's strided sources
    lanes, _, s = _dbn_layout()
    rng = np.random.default_rng(1)
    n = len(tdbn._tempo_grid(55.0, 215.0, 100))
    assert n <= s * lanes
    lastv = _values(kind, (n, 1), rng)
    log_trans = tdbn._tempo_transition(55.0, 215.0, 100, 100.0)
    if kind in ("all equal", "-1e30 padding"):
        log_trans = np.zeros_like(log_trans)  # every source ties, or only the padding's values remain
    cand = np.ascontiguousarray((lastv + log_trans).T)  # [to, from]
    runs = [list(range(lane * s, lane * s + s)) for lane in range(lanes)]
    forward, _ = _xor_tree(*_lane_scans(torch.from_numpy(cand), runs, [run[0] for run in runs]))
    strided = [list(range(lane, n, 32)) for lane in range(32)]
    v, i = _xor_tree(*_lane_scans(torch.from_numpy(cand), strided, [BIG] * 32))
    _check(v, i, cand)
    assert torch.equal(forward, v)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("n_bins", [241, 301, 700])
@pytest.mark.parametrize("band", [1, 25, 127])
def test_banded_propagation_by_lanes_is_the_first_maximum(band, n_bins, kind):
    # per bin, the 2 band + 1 candidates s[b + k - band] + log_tri[k], -inf outside the bins
    lanes, _, _ = _banded_layout()
    rng = np.random.default_rng(band + n_bins)
    s = _values(kind, (1, n_bins), rng)[0]
    offsets = np.arange(-band, band + 1)
    tri = (band + 1.0 - np.abs(offsets)).astype(np.float32)
    log_tri = np.log(tri / tri.sum()).astype(np.float32)  # symmetric, so two offsets tie on a flat row
    padded = np.concatenate([np.full(band, -np.inf, np.float32), s, np.full(band, -np.inf, np.float32)])
    cand = np.lib.stride_tricks.sliding_window_view(padded, 2 * band + 1) + log_tri  # [n_bins, 2 band + 1]
    per_lane = -(-(2 * band + 1) // lanes)
    runs = [list(range(q * per_lane, min((q + 1) * per_lane, 2 * band + 1))) for q in range(lanes)]
    v, _ = _xor_tree(*_lane_scans(torch.from_numpy(cand), runs, [q * per_lane for q in range(lanes)]))
    # the backtrack: ballots over 32 offsets at a time, the first chunk with a hit, its lowest set lane
    hits = torch.from_numpy(cand) == v[:, None]
    i = torch.full_like(v, -1, dtype=torch.int64)
    for chunk in range(0, 2 * band + 1, 32):
        ballot = hits[:, chunk : chunk + 32]
        first = chunk + torch.argmax(ballot.to(torch.uint8), dim=-1)
        i = torch.where((i < 0) & ballot.any(dim=-1), first, i)
    _check(v, i, cand)


@pytest.mark.parametrize("kind", KINDS)
def test_dbn_final_argmax_by_lanes_and_warps_is_the_first_maximum(kind):
    # [84, 110] scores, -1e30 past each tempo's interval: R phases per lane, kLanes lanes per tempo,
    # a warp's 32 lanes, then the warps
    lanes, r, _ = _dbn_layout()
    rng = np.random.default_rng(3)
    intervals = tdbn._tempo_grid(55.0, 215.0, 100)
    n, P = len(intervals), int(intervals.max())
    assert P <= r * lanes
    score = _values(kind, (n, P), rng)
    score[np.arange(P)[None, :] >= intervals[:, None]] = NEG
    flat = score.reshape(1, -1)
    threads = (n * lanes + 31) // 32 * 32
    runs, start = [], []
    for tid in range(threads):
        j, base = tid // lanes, tid % lanes * r
        runs.append([j * P + p for p in range(base, base + r) if j < n and p < P])
        start.append(BIG)
    lane_v, lane_i = _lane_scans(torch.from_numpy(flat), runs, start)
    warp_v, warp_i = _xor_tree(lane_v.reshape(1, -1, 32), lane_i.reshape(1, -1, 32))
    pad = 32 - warp_v.shape[-1]
    v, i = _xor_tree(torch.cat([warp_v, torch.full((1, pad), -float("inf"))], -1),
                     torch.cat([warp_i, torch.full((1, pad), BIG, dtype=torch.int64)], -1))
    _check(v, i, flat)


def test_the_emulated_partitions_cover_the_kernels_limits():
    lanes, r, s = _dbn_layout()
    assert lanes & (lanes - 1) == 0 and 32 % lanes == 0 and s % 4 == 0  # float4 loads of a lane's run
    n = len(tdbn._tempo_grid(55.0, 215.0, 100))
    assert n <= s * lanes and int(tdbn._tempo_grid(55.0, 215.0, 100).max()) <= r * lanes
    lanes, bins, max_bins = _banded_layout()
    assert lanes == bins and lanes & (lanes - 1) == 0 and 32 % lanes == 0  # lane q finishes bin q of its group
    assert -(-max_bins // bins) * lanes <= 1024  # every group in one block
