"""The decoder kernels' partitioned first-maximum reductions, emulated with torch.

csrc/dbn_viterbi.cu and csrc/banded_viterbi.cu split each argmax over a
group of lanes: every lane scans its own ascending candidates with a strict
> (a NaN above a number), starting from (-inf, its first index); the
banded kernel's group then combines (value, index) pairs by xor shuffles,
the larger value winning (a NaN above every number) and the lower index a
tie, and the DBN's warp takes the largest order-preserving integer key and
the lowest index holding it (two redux.sync). The DBN's forward pass takes only the maximum entering each
phase 0 (each of kLanes lanes over a run of S of the 84 source tempi, padded
to S kLanes with -inf, then the group); its backtrack recomputes the first
maximum at each beat with the 32 lanes of a warp, lane i taking the sources
i, i + 32, ...; the banded Viterbi's forward pass takes only the maximum
(lane q of kLanes over the offsets q C .. q C + C - 1 of the 2 band + 1
candidates, bins outside the range -inf), and its backtrack the lowest
offset whose sum equals it, 32 offsets to a ballot; the DBN's final argmax over [n, P] gives each lane R phases of one
tempo (-1e30 past the tempo's interval), then reduces over the warp and
over the warps. Here the same partitions and the same shuffle trees run on
tie-heavy inputs (all-equal rows, two-level rows, -1e30 padding, NaNs) and must
give torch.argmax's and jnp.argmax's first maximum and its value, NaNs
included. The dense Viterbi's warp layout (a NaN-propagating max over 32
padded sources, the backtrack's first source whose sum hits the kept
maximum) and the onset rule's word walk run against the plain loops. The
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
from test_torch_fused import torch_threads  # noqa: F401 (an autouse fixture)

NEG = -1e30
BIG = 2**31 - 1  # INT_MAX: the index a lane with no candidate starts from
KINDS = ["random", "all equal", "two levels", "-1e30 padding", "NaNs"]


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
        # the kernels' before(): a NaN above every number, the lower index on a tie (two NaNs tie)
        p_nan, v_nan = pv.isnan(), v.isnan()
        take = torch.where(p_nan | v_nan, p_nan & (~v_nan | (pi < i)), (pv > v) | ((pv == v) & (pi < i)))
        v, i = torch.where(take, pv, v), torch.where(take, pi, i)
        off //= 2
    assert ((v == v[..., :1]) | (v.isnan() & v[..., :1].isnan())).all() and (i == i[..., :1]).all()
    return v[..., 0], i[..., 0]


def _redux_first(v: torch.Tensor, i: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The DBN's warp step over the last axis: the largest integer key
    (``_max_key``: NaN above every number), then the lowest index holding it
    (two redux.sync); the value is that index's."""
    key = _max_key(v)
    hit = key == key.max(dim=-1, keepdim=True).values
    first = torch.where(hit, i, torch.full_like(i, BIG)).min(dim=-1).values
    return v.gather(-1, torch.argmax((i == first[..., None]).to(torch.uint8), dim=-1, keepdim=True))[..., 0], first


def _lane_scans(cand: torch.Tensor, runs: list[list[int]], start: list[int]) -> tuple[torch.Tensor, torch.Tensor]:
    """Each lane's ascending scan with a strict > over cand[..., run] (an
    index past the last candidate is -inf), a NaN above a number, from
    (-inf, start): [..., lanes]."""
    n = cand.shape[-1]
    vals, idxs = [], []
    for run, first in zip(runs, start):
        bv = torch.full(cand.shape[:-1], -float("inf"))
        bi = torch.full(cand.shape[:-1], first, dtype=torch.int64)
        for k in run:
            v = cand[..., k] if k < n else torch.full_like(bv, -float("inf"))
            take = (v > bv) | (v.isnan() & ~bv.isnan())
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
    if kind == "NaNs":  # a few NaNs, and a row of them: each the maximum, the first one the argmax
        x = (-50.0 * rng.random(shape)).astype(np.float32)
        x[rng.random(shape) < 0.02] = np.nan
        x[..., ::7, :] = np.nan
        return x
    x = np.where(rng.random(shape) < 0.7, NEG, -2.0).astype(np.float32)  # mostly -1e30, and rows of it only
    x[..., ::5, :] = NEG
    return x


def _check(v: torch.Tensor, i: torch.Tensor, cand: np.ndarray) -> None:
    ref = torch.argmax(torch.from_numpy(cand), dim=-1)
    assert torch.equal(i, ref)
    np.testing.assert_array_equal(i.numpy(), np.asarray(jnp.argmax(jnp.asarray(cand), axis=-1)))
    torch.testing.assert_close(v, torch.from_numpy(cand).max(dim=-1).values, rtol=0.0, atol=0.0, equal_nan=True)


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
    v, i = _redux_first(*_lane_scans(torch.from_numpy(cand), strided, [BIG] * 32))
    _check(v, i, cand)
    torch.testing.assert_close(forward, v, rtol=0.0, atol=0.0, equal_nan=True)


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
    # the backtrack: ballots over 32 offsets at a time, the first chunk with a hit (a sum equal to
    # the maximum, or a NaN), its lowest set lane
    hits = (torch.from_numpy(cand) == v[:, None]) | torch.from_numpy(cand).isnan()
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
    warp_v, warp_i = _redux_first(lane_v.reshape(1, -1, 32), lane_i.reshape(1, -1, 32))
    pad = 32 - warp_v.shape[-1]
    v, i = _redux_first(torch.cat([warp_v, torch.full((1, pad), -float("inf"))], -1),
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


# ---- the dense Viterbi's warp layout and the onset rule's word walk ------


def _max_key(v: torch.Tensor) -> torch.Tensor:
    """csrc/dense_viterbi.cu's max_key: the float order as signed integers, -0 as +0, every NaN INT_MAX."""
    i = (v + 0.0).view(torch.int32)
    key = torch.where(i >= 0, i, i ^ 0x7FFFFFFF)
    return torch.where(v.isnan(), torch.full_like(key, BIG), key)


def _dense_warp_layout(log_em: torch.Tensor, trans: torch.Tensor, init: torch.Tensor):
    """The warp layout's schedule: the forward pass keeps each frame's score
    and each target's NaN-propagating maximum over 32 padded sources (-inf
    scores plus 0); the final state is the first maximum of integer keys (a
    warp reduction, then a ballot); the backtrack takes, for the path's
    state, the first source whose sum equals the kept maximum or is a NaN."""
    B, T, S = log_em.shape
    pad = 32 - S
    col = torch.cat([trans, torch.zeros(pad, S)], 0)  # [32 from, S to]
    score = init + log_em[:, 0]
    hist, maxima = [], []
    for t in range(1, T):
        padded = torch.cat([score, torch.full((B, pad), -float("inf"))], 1)
        m = (padded[:, :, None] + col).max(dim=1).values  # propagates a NaN, as the max.NaN tree
        hist.append(score)
        maxima.append(m)
        score = m + log_em[:, t]
    key = _max_key(score)
    s = torch.argmax((key == key.max(dim=1, keepdim=True).values).to(torch.uint8), dim=1)  # the ballot's lowest lane
    best = score.gather(1, s[:, None])[:, 0]
    path = [s]
    for h, m in zip(reversed(hist), reversed(maxima)):
        sums = h + trans[:, s].T  # [B, from]
        target = m.gather(1, s[:, None])
        hits = (sums == target) | sums.isnan()
        assert hits.any(dim=1).all()
        s = torch.argmax(hits.to(torch.uint8), dim=1)  # the ballot's lowest lane
        path.append(s)
    return torch.stack(path[::-1], 1).to(torch.int32), best


@pytest.mark.parametrize("kind", ["random", "ties", "one NaN", "NaN row", "forbidden moves", "signed zeros"])
def test_dense_warp_layout_recomputes_the_first_argmax(kind):
    from audiotabs_tpu_torch.decode import viterbi as tvit

    rng = np.random.default_rng(43)
    B, T, S = 3, 50, 25
    em = rng.random((B, T, S)).astype(np.float32) + 0.01
    trans = rng.random((S, S)).astype(np.float32) + 0.1
    if kind == "ties":
        em[:, 10:30] = 0.5
        trans[:] = 1.0
    log_em = np.log(em / em.sum(-1, keepdims=True)).astype(np.float32)
    log_trans = np.log(trans / trans.sum(-1, keepdims=True)).astype(np.float32)
    if kind == "one NaN":
        log_em[0, T // 3, 4] = np.nan
    elif kind == "NaN row":
        log_em[1] = np.nan
    elif kind == "forbidden moves":  # log 0: -inf sums, and whole -inf columns
        log_trans[rng.random((S, S)) < 0.5] = -np.inf
        log_trans[:, 3] = -np.inf
        np.fill_diagonal(log_trans, 0.0)
    elif kind == "signed zeros":  # sums of -0 and +0 tie
        log_em[:] = -0.0
        log_em[:, ::2, ::3] = 0.0
        log_trans[:] = 0.0
    init = np.full(S, -np.log(S), np.float32)
    args = [torch.from_numpy(a) for a in (log_em, log_trans, init)]
    path, best = _dense_warp_layout(*args)
    ref_path, ref_best = tvit.viterbi_log_dense_plain(*args)
    assert torch.equal(path, ref_path)
    assert torch.equal(best.isnan(), ref_best.isnan()) and torch.equal(best[~best.isnan()], ref_best[~ref_best.isnan()])


def _onset_word_walk(cand: np.ndarray, wait: int) -> np.ndarray:
    """csrc/onset_wait.cu's schedule on one row: rounds of 32 words of 32
    frames (bit i of word k: frame base + 32 k + i); a wait above 0 walks from
    at = next - base (within the round): each lane's first candidate at or
    after it, their minimum fires, and at moves past it by min(wait, 1024) + 1;
    next carries the round's last onset plus wait + 1. A wait of 0 or less
    fires every candidate."""
    T = cand.shape[0]
    fired = np.zeros(T, bool)
    nxt = 0
    for base in range(0, T, 1024):
        words = [sum(1 << i for i in range(32) if base + 32 * k + i < T and cand[base + 32 * k + i]) for k in range(32)]
        if wait <= 0:
            out = words
        else:
            out = [0] * 32
            step = min(wait, 1024) + 1
            at, last = min(max(nxt - base, 0), 1024), -1
            while True:
                firsts = []
                for k in range(32):
                    rel = at - 32 * k
                    left = words[k] if rel <= 0 else 0 if rel >= 32 else words[k] & ((0xFFFFFFFF << rel) & 0xFFFFFFFF)
                    firsts.append(32 * k + (left & -left).bit_length() - 1 if left else BIG)
                first = min(firsts)
                if first == BIG:
                    break
                out[first >> 5] |= 1 << (first & 31)
                last, at = first, first + step
            if last >= 0:
                nxt = base + last + wait + 1
        for k in range(32):
            for i in range(32):
                if base + 32 * k + i < T:
                    fired[base + 32 * k + i] = bool(out[k] >> i & 1)
    return fired


@pytest.mark.parametrize("T", [1, 130, 1024, 1292, 2100])
@pytest.mark.parametrize("wait", [-2, 0, 1, 4, 31, 33, 1023, 1024, 1025, 2000])
def test_onset_word_walk_is_the_wait_rule(T, wait):
    from audiotabs_tpu_torch.ops import onset as tonset

    rng = np.random.default_rng(T + abs(wait))
    for density in (0.05, 0.3, 1.0):
        cand = rng.random((2, T)) < density
        ref = tonset._wait_plain(torch.from_numpy(cand), wait).numpy()
        for r in range(2):
            np.testing.assert_array_equal(_onset_word_walk(cand[r], wait), ref[r], err_msg=f"density {density} row {r}")


def test_the_warp_layout_and_the_word_walk_read_the_kernels_constants():
    dense, onset = _source("dense_viterbi"), _source("onset_wait")
    assert re.search(r"constexpr int kWarpStates = 32;", dense) and "S <= kWarpStates" in dense
    assert re.search(r"constexpr int kRoundFrames = 1024;", onset)


def _min_key(v: torch.Tensor) -> torch.Tensor:
    """csrc/constant_switch_viterbi.cu's min_key on float32: the signed order
    of the floats that are not NaN, -0 just below +0; a NaN's key is its
    bits' (the frame's minimum is a NaN through sw + X wherever one counts)."""
    i = v.view(torch.int32)
    return i ^ ((i >> 31) & 0x7FFFFFFF)


def _key_value(k: torch.Tensor) -> torch.Tensor:
    """The kernel's key_value: the inverse of ``_min_key``."""
    return (k ^ ((k >> 31) & 0x7FFFFFFF)).view(torch.float32)


def _first(hit: torch.Tensor) -> int:
    """The ballot's lowest set lane: the first True."""
    assert hit.any()
    return int(torch.argmax(hit.to(torch.uint8)))


def _switch_schedule(em: torch.Tensor, penalty: float) -> tuple[torch.Tensor, torch.Tensor]:
    """csrc/constant_switch_viterbi.cu's schedule on one sequence [S, T]:
    frame t's minimum is m_t = min(A, sw + X), with A = min(dp + x_t) reduced
    over integer keys a frame ahead and X = min(x_t), and the pass keeps only
    each frame's scores dp_t and m_t. The backtrack walks rounds of 32
    frames: s stays into frame t + 1 when dp_t[s] <= m_t + penalty; the
    first frame of a round where it does not is a switch, and only there
    argm, the first state of dp_t equal to m_t (or a NaN), is found. The
    confidences are gathered after it."""
    S, T = em.shape
    logp = -torch.log(torch.clamp(em, 1e-9, 1.0))
    X = logp.amin(dim=0)  # NaN-propagating, as the lanes' min.NaN.f32
    p = torch.tensor(penalty, dtype=torch.float32)
    dp = logp[:, 0].clone()
    m = X[0]
    sw = m + p
    a_key = _min_key(dp + logp[:, 1]).min() if T > 1 else None
    dps, ms = [dp], [m]
    for t in range(1, T):
        dp = torch.minimum(dp, sw) + logp[:, t]  # min.NaN.f32
        if t + 1 < T:
            a_next = _min_key(dp + logp[:, t + 1]).min()
        m = torch.minimum(_key_value(a_key), sw + X[t])
        sw = m + p
        dps.append(dp)
        ms.append(m)
        if t + 1 < T:
            a_key = a_next

    def first_min(t: int) -> int:
        return _first((dps[t] == ms[t]) | dps[t].isnan())

    path = [0] * T
    s = path[T - 1] = first_min(T - 1)
    for hi in range(T - 2, -1, -32):
        n = min(32, hi + 1)
        j = 0
        while j < n:  # lane jj holds the scores after frame hi - jj
            leave = [jj for jj in range(j, n) if not bool(dps[hi - jj][s] <= ms[hi - jj] + p)]
            jn = leave[0] if leave else n
            for jj in range(j, jn):
                path[hi - jj] = s
            if jn == n:
                break
            s = path[hi - jn] = first_min(hi - jn)
            j = jn + 1
    path = torch.tensor(path)
    return path.to(torch.int32), em[path, torch.arange(T)]


@pytest.mark.parametrize("kind", ["random", "equal columns", "at min + penalty", "one NaN", "NaN row", "signed zeros"])
@pytest.mark.parametrize("S,T", [(49, 301), (61, 97), (7, 1), (33, 2), (25, 32), (25, 33), (64, 65)])
def test_switch_lookahead_minimum_and_walk_are_the_plain_decode(kind, S, T):
    from audiotabs_tpu_torch.decode import viterbi as tvit
    from test_torch_decoder_kernels import _switch_emissions

    if kind == "signed zeros":  # emissions of 1: costs of -0, ties of -0 and +0 sums
        em = torch.from_numpy(_switch_emissions("random", 2, S, T))
        em[:, ::2, ::3] = 1.0
        penalty = 0.0
    else:
        em = torch.from_numpy(_switch_emissions(kind, 2, S, T))
        penalty = float(-np.log(np.float32(0.5))) if kind == "at min + penalty" else 2.5
    ref_path, ref_conf = tvit.viterbi_constant_switch_plain(em, penalty)
    for b in range(2):
        path, conf = _switch_schedule(em[b], penalty)
        assert torch.equal(path, ref_path[b]), b
        assert torch.equal(conf.isnan(), ref_conf[b].isnan()) and torch.equal(conf[~conf.isnan()], ref_conf[b][~conf.isnan()])


def _envelope_schedule(sal: torch.Tensor, stride: int, decay: float) -> torch.Tensor:
    """csrc/salience_envelope.cu's schedule on one row [88, T]: 32-frame
    segment maxima over the valid frames, the block maxima from stride / 32
    segments each (a partial last block with the padding's 0), the row's
    maximum from the segments; lane 0 scans forward from block 0 and lane 1
    in reverse from block nblk - 1, the same steps."""
    F_, T = sal.shape
    n_seg, nblk, per = -(-T // 32), max(1, -(-T // stride)), stride // 32
    segs = [sal[:, 32 * q : 32 * q + 32].amax() for q in range(n_seg)]
    g = torch.stack(segs).amax()
    m = []
    for i in range(nblk):
        v = torch.tensor(0.0 if (i + 1) * stride > T else -float("inf"))
        for q in range(i * per, min((i + 1) * per, n_seg)):
            v = torch.maximum(v, segs[q])
        m.append(v)
    sc = [[None] * nblk, [None] * nblk]
    for lane in (0, 1):
        e = torch.tensor(0.0)
        for i in range(nblk):
            at = nblk - 1 - i if lane else i
            e = torch.maximum(m[at], decay * e)
            sc[lane][at] = e
    fl = 0.05 * g
    return torch.stack([torch.maximum(torch.maximum(a, b), fl) for a, b in zip(*sc)])


@pytest.mark.parametrize("kind", ["random", "negative", "loud then silent", "one NaN", "NaN row"])
@pytest.mark.parametrize("T,stride", [(1, 64), (37, 64), (64, 64), (65, 64), (345, 64), (700, 64), (130, 64)])
def test_envelope_segments_blocks_and_lane_scans_are_the_plain_envelope(kind, T, stride):
    from audiotabs_tpu_torch.models import basicpitch as tbp
    from test_torch_decoder_kernels import _salience

    sal = torch.from_numpy(_salience(kind, 2, T))
    ref = tbp.salience_envelope_plain(sal, stride, tbp.ENVELOPE_DECAY)
    for r in range(2):
        got = _envelope_schedule(sal[r], stride, tbp.ENVELOPE_DECAY)
        assert torch.equal(got.isnan(), ref[r].isnan()) and torch.equal(got[~got.isnan()], ref[r][~got.isnan()]), r


def test_the_switch_and_envelope_schedules_read_the_kernels_constants():
    from audiotabs_tpu_torch.models import basicpitch as tbp

    switch, envelope = _source("constant_switch_viterbi"), _source("salience_envelope")
    assert re.search(r"constexpr int kTile = 32;", switch) and "for (int hi" not in switch
    assert re.search(r"const int n_rounds = \(T \+ 30\) / 32;", switch) and "T - 2 - 32 * r" in switch
    assert "const float* in = m + (lane ? nblk - 1 : 0);" in envelope and "const int step = lane ? -1 : 1;" in envelope
    assert "constexpr int kStride = 64;" in envelope and "if (stride != kStride) return -2;" in envelope
    assert tbp.ENVELOPE_STRIDE == 64  # the one stride the kernel takes


# ---- the DBN's general layout (grids past the register layouts) ----------

WIDE_GRIDS = [(30.0, 215.0, 100), (55.0, 215.0, 200), (20.0, 300.0, 100), (10.0, 400.0, 100)]


def _general_constants() -> tuple[int, int]:
    """(kGeneralThreads, kGeneralChunk) of csrc/dbn_viterbi.cu."""
    text = _source("dbn_viterbi")
    return tuple(int(re.search(rf"constexpr int {name} = (\d+);", text).group(1)) for name in ("kGeneralThreads", "kGeneralChunk"))


def _dbn_general_layout(act: torch.Tensor, fps: int, min_bpm: float, max_bpm: float) -> tuple[torch.Tensor, torch.Tensor]:
    """The general layout's schedule on one song [T]: tempo i's phases in a
    circular buffer of L_i slots at off[i] (phase p at frame t in slot
    (p - t) mod L_i); each target's entry the maximum over ls lanes' sources
    (lane s: s, s + ls, ...); then every slot adds its observation, the
    phase-0 slot to the entry, and the last phase is kept; the final argmax
    by 1,024 threads each scanning flat indices tid, tid + 1,024, ..., then a
    warp's and the block's first maximum of keys; the backtrack from the kept
    last phases."""
    threads, _ = _general_constants()
    f = tdbn._forward_inputs(act[None], fps, min_bpm, max_bpm, 100.0, 16)
    g = f.grid
    L = g.intervals
    n, P = g.valid.shape
    bl = g.beat_len32.to(torch.int64)
    off = torch.cumsum(L, 0) - L
    tempo_of = torch.repeat_interleave(torch.arange(n), L)  # each slot's tempo
    slot = torch.arange(int(L.sum())) - off[tempo_of]
    Ls, bls = L[tempo_of], bl[tempo_of]
    buf = f.init[0][tempo_of, slot].clone()  # frame 0: phase q in slot q
    last = (slot == Ls - 1)
    lastv = buf[last]
    hist = [lastv]
    ls = 1
    while ls < 32 and 2 * ls * n <= threads:
        ls *= 2
    T = act.shape[0]
    for t in range(1, T):
        cand = lastv[:, None] + g.log_trans  # [from, to]
        enter = torch.stack([cand[s::ls].amax(dim=0) for s in range(ls)]).amax(dim=0)  # a NaN propagates
        p = (slot + t) % Ls
        obs = torch.where(p < bls, f.lo_beat[0, t], f.lo_off[0, t])
        buf = torch.where(p == 0, enter[tempo_of], buf) + obs
        lastv = torch.zeros(n).index_put_((tempo_of[p == Ls - 1],), buf[p == Ls - 1])
        hist.append(lastv)
    # the final [n, P] score read through the slot map, -1e30 past each interval
    p_all = torch.arange(P)[None, :]
    q = (p_all - (T - 1) % L[:, None]) % L[:, None]
    final = torch.where(g.valid, buf[(off[:, None] + q).clamp(max=len(buf) - 1)], torch.tensor(NEG))
    flat = final.reshape(-1)
    cols = -(-flat.numel() // threads)
    padded = torch.cat([flat, torch.full((cols * threads - flat.numel(),), -float("inf"))]).reshape(cols, threads)
    k = torch.argmax(padded, dim=0)  # each thread's ascending scan: the first maximum, a NaN first
    lane_v = padded.gather(0, k[None])[0]
    lane_i = torch.where(k * threads + torch.arange(threads) < flat.numel(), k * threads + torch.arange(threads), BIG)
    warp_v, warp_i = _redux_first(lane_v.reshape(-1, 32), lane_i.reshape(-1, 32))
    _, bi = _redux_first(warp_v[None], warp_i[None])
    tempo, phase, k = int(bi) // P, int(bi) % P, T - 1
    phases, ivs = torch.empty(T, dtype=torch.int32), torch.empty(T, dtype=torch.int32)
    while True:
        lo = max(k - phase, 0)
        phases[lo : k + 1] = phase - (k - torch.arange(lo, k + 1))
        ivs[lo : k + 1] = int(L[tempo])
        if lo == 0:
            break
        tempo = int(torch.argmax(hist[lo - 1] + g.log_trans[:, tempo]))  # the first maximum, a NaN first
        phase, k = int(L[tempo]) - 1, lo - 1
    return phases, ivs


@pytest.mark.parametrize("grid", WIDE_GRIDS, ids=lambda g: f"{g[0]:g}-{g[1]:g}bpm-{g[2]}fps")
@pytest.mark.parametrize("kind", ["random", "constant", "beats", "one NaN", "NaN row"])
def test_dbn_general_layout_is_the_plain_decode(grid, kind):
    from test_torch_decoder_kernels import _activations

    min_bpm, max_bpm, fps = grid
    intervals = tdbn._tempo_grid(min_bpm, max_bpm, fps)
    lanes, r, s = _dbn_layout()
    assert len(intervals) > 16 * lanes or intervals.max() > 20 * lanes  # past both register layouts
    act = torch.from_numpy(_activations(kind, B=1, T=240))
    ph, iv = tdbn._dbn_forward_plain(act, fps, min_bpm, max_bpm, 100.0, 16)
    for b in range(len(act)):
        got = _dbn_general_layout(act[b], fps, min_bpm, max_bpm)
        assert torch.equal(got[0], ph[b]) and torch.equal(got[1], iv[b]), b


def test_the_general_layout_reads_the_kernels_constants():
    threads, chunk = _general_constants()
    text = _source("dbn_viterbi")
    assert threads == 1024 and chunk & (chunk - 1) == 0
    assert "while (ls < 32 && 2 * ls * n <= kGeneralThreads) ls *= 2;" in text  # the emulation's lanes per target
    assert "int q = p - (T - 1) % Li;" in text and "int p = q + tm;" in text  # the slot map both ways
    assert "return launch_any_grid(" in text and "n > 255" not in text
