"""The six decoder kernels against their plain loops, on the card.

``_dbn_forward``, the onset wait rule, ``_banded_viterbi``,
``viterbi_log_dense``, ``viterbi_constant_switch`` and ``salience_envelope``
launch csrc/dbn_viterbi.cu, onset_wait.cu, banded_viterbi.cu,
dense_viterbi.cu, constant_switch_viterbi.cu and salience_envelope.cu for a
CUDA tensor; each launch must add one to its count in the tracer
(``<kernel>_launches``) and give exactly the
plain loop's output, on random and tie-heavy inputs made from numpy seeds
(the same inputs tests/test_torch_decoders.py and
tests/test_torch_scan_kernels.py hold the plain loops against the JAX
package with), with a NaN where the loops take one ("one NaN", "NaN row":
a NaN is the maximum, as torch.argmax and jnp.argmax take it; a NaN output
equals a NaN). The DBN runs at every tempo grid the JAX scan takes: past
the register layouts (128 tempi, 160 phases) its general layout, held here
at the grids of ``WIDE_GRIDS`` (tests/test_torch_decoders.py holds the
plain loop against the JAX scan at the first three). Every test here is
``cuda``-marked and skips without a card. The file imports no JAX, so it
also runs where only PyTorch is installed:

    python -m pytest --noconftest tests/test_torch_decoder_kernels.py -m cuda
"""

from __future__ import annotations

import ctypes
import importlib

import numpy as np
import pytest
import torch

from audiotabs_tpu_torch import _build, tracing
from audiotabs_tpu_torch.decode import dbn_beats as tdbn
from audiotabs_tpu_torch.decode import viterbi as tvit
from audiotabs_tpu_torch.models import basicpitch as tbp
from audiotabs_tpu_torch.ops import onset as tonset

# the ops package re-exports the pyin function under the module's name
tpyin = importlib.import_module("audiotabs_tpu_torch.ops.pyin")

# (min_bpm, max_bpm, fps) past the register layouts: 174 tempi x 200 phases,
# 165 x 219, 281 x 300 (a score of 44,960 states, the largest that one block's
# shared memory holds of these) and 586 x 600 (180,195 states, in device memory)
WIDE_GRIDS = [(30.0, 215.0, 100), (55.0, 215.0, 200), (20.0, 300.0, 100), (10.0, 400.0, 100)]


# ---- inputs --------------------------------------------------------------


def _with_nans(x: np.ndarray, kind: str) -> np.ndarray:
    """"one NaN": a NaN a third of the way into row 0 (in the middle state or
    bin, not the first, which a scan starts from); "NaN row": row 1 all NaN
    (row 0 when there is one row)."""
    x = x.copy()
    if kind == "one NaN":
        x[(0, x.shape[1] // 3) + tuple(n // 2 for n in x.shape[2:])] = np.nan
    else:
        x[min(1, len(x) - 1)] = np.nan
    return x


def _activations(kind: str, B: int = 3, T: int = 400) -> np.ndarray:
    rng = np.random.default_rng(7)
    t = np.arange(T)
    if kind == "random":
        return rng.random((B, T)).astype(np.float32)
    if kind in ("one NaN", "NaN row"):
        return _with_nans(rng.random((B, T)).astype(np.float32), kind)
    if kind == "constant":  # every frame ties with every other
        return np.full((B, T), 0.5, np.float32)
    # beats at three tempi, on two activation levels, with a gap
    rows = []
    for period in (50, 37, 64):
        a = np.where(t % period < 3, 0.9, 0.05).astype(np.float32)
        a[150:210] = 0.05
        rows.append(a)
    return np.stack(rows[:B])


def _envelopes(kind: str, B: int = 4, T: int = 130) -> np.ndarray:
    rng = np.random.default_rng(11)
    if kind == "random":
        return rng.random((B, T)).astype(np.float32)
    # plateaus: runs of equal values, so local maxima tie along the run
    levels = rng.integers(0, 4, (B, T // 5 + 1)).astype(np.float32)
    return np.repeat(levels, 5, axis=1)[:, :T]


def _pyin_obs(kind: str, R: int = 3, T: int = 30, n_bins: int = 40) -> tuple[np.ndarray, np.ndarray]:
    rng = np.random.default_rng(13)
    if kind in ("random", "one NaN", "NaN row"):
        obs = rng.random((R, T, n_bins)).astype(np.float32)
        obs /= obs.sum(-1, keepdims=True) * rng.uniform(1.0, 3.0, (R, T, 1))
        if kind != "random":
            obs = _with_nans(obs, kind)
    else:  # equal columns and a few levels: candidates tie within the band
        obs = (rng.integers(0, 3, (R, T, 1)) * np.ones((1, 1, n_bins)) / (3 * n_bins)).astype(np.float32)
        obs[:, ::4, n_bins // 2] = 0.5
    voiced = np.clip(obs.sum(-1), 0.0, 1.0)
    log_v = np.log(obs + np.float32(1e-10)).astype(np.float32)
    log_u = np.broadcast_to(np.log(np.maximum(1.0 - voiced, np.float32(1e-10)) / n_bins)[..., None], obs.shape)
    return log_v, np.ascontiguousarray(log_u, dtype=np.float32)


def _emissions(kind: str, B: int = 3, T: int = 60, S: int = 7) -> tuple[np.ndarray, np.ndarray]:
    rng = np.random.default_rng(17)
    em = rng.random((B, T, S)).astype(np.float32) + 0.01
    trans = rng.random((S, S)).astype(np.float32) + 0.1
    if kind == "ties":
        em[:, 10:30] = 0.5  # equal emission columns
        trans[:] = 1.0  # uniform transitions: every source state ties
    em /= em.sum(-1, keepdims=True)
    trans /= trans.sum(-1, keepdims=True)
    log_em = np.log(em).astype(np.float32)
    if kind in ("one NaN", "NaN row"):
        log_em = _with_nans(log_em, kind)
    return log_em, np.log(trans).astype(np.float32)


def _nans_along_frames(x: np.ndarray, kind: str) -> np.ndarray:
    """``_with_nans`` on [B, rows, T]: "one NaN" a third of the way into the
    frames of row 0, in its middle state or pitch; "NaN row" row 1 (or 0)."""
    return np.ascontiguousarray(_with_nans(x.swapaxes(1, -1), kind).swapaxes(1, -1))


def _switch_emissions(kind: str, B: int = 3, S: int = 49, T: int = 301) -> np.ndarray:
    """[B, S, T] chord-state probabilities. "equal columns": every third frame
    all states are equal; "at min + penalty": probabilities 1, 1/2 and 1/4,
    costs 0, c and 2c, so with a penalty of c = -log(1/2) costs land exactly
    on the minimum plus the penalty; "one NaN", "NaN row": the random
    probabilities with NaNs (``_nans_along_frames``)."""
    rng = np.random.default_rng(29)
    if kind == "at min + penalty":
        return rng.choice(np.array([1.0, 0.5, 0.25], np.float32), size=(B, S, T))
    em = rng.random((B, S, T)).astype(np.float32) ** 4 + np.float32(1e-3)
    if kind == "equal columns":
        em[:, :, ::3] = 1.0
    em /= em.sum(1, keepdims=True)
    return _nans_along_frames(em, kind) if kind in ("one NaN", "NaN row") else em


def _salience(kind: str, R: int = 2, T: int = 2584) -> np.ndarray:
    """[R, 88, T] salience. "loud then silent": the decay decides the
    envelope; "constant": every block maximum ties; "negative": the last
    block's padding zeros are its maximum, above the row's maximum; "one
    NaN", "NaN row": the random salience with NaNs (``_nans_along_frames``)."""
    rng = np.random.default_rng(31)
    x = rng.random((R, 88, T)).astype(np.float32)
    if kind == "constant":
        return np.full((R, 88, T), 0.25, np.float32)
    if kind == "negative":
        return -x - 0.5
    if kind == "loud then silent":
        x *= 0.02
        x[:, :, : T // 4] += 1.0
    if kind in ("one NaN", "NaN row"):
        return _nans_along_frames(x, kind)
    return x


# ---- on the card ---------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the decoder kernels have no CPU mode")
    return torch.device("cuda")


def _same(got, ref) -> bool:
    """Every output equal in shape, type and value, a NaN equal to a NaN."""
    pairs = list(zip(got, ref)) if isinstance(got, tuple) else [(got, ref)]
    return all(g.shape == r.shape and g.dtype == r.dtype and bool(((g == r) | (g.isnan() & r.isnan())).all())
               if g.is_floating_point() else torch.equal(g, r) for g, r in pairs)


def _launched(kernel: str, fn):
    """``fn()``, which must launch csrc/<kernel>.cu once: one more ``<kernel>_launches`` in the tracer."""
    before = tracing.counters().get(f"{kernel}_launches", 0)
    out = fn()
    torch.cuda.synchronize()
    assert tracing.counters()[f"{kernel}_launches"] == before + 1
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["random", "constant", "beats", "one NaN", "NaN row"])
def test_cuda_dbn_kernel_equals_plain_version(cuda, kind):
    act = torch.from_numpy(_activations(kind)).to(cuda)
    got = _launched("dbn_viterbi", lambda: tdbn._dbn_forward(act))
    ref = tdbn._dbn_forward_plain(act, 100, 55.0, 215.0, 100.0, 16)
    assert all(torch.equal(g, r) for g, r in zip(got, ref))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["random", "plateaus"])
def test_cuda_onset_kernel_equals_plain_version(cuda, kind):
    env = torch.from_numpy(_envelopes(kind)).to(cuda)
    cand = env >= env.mean(dim=-1, keepdim=True)
    got = _launched("onset_wait", lambda: tonset._wait(cand, 4))
    assert torch.equal(got, tonset._wait_plain(cand, 4))


@pytest.mark.cuda
@pytest.mark.parametrize("R,T", [(20, 130), (80, 130), (10, 173), (1, 1292), (4, 1292), (1, 7752), (3, 1024), (5, 1)])
@pytest.mark.parametrize("wait", [4, 0, -3, 31, 40, 10**12])
def test_cuda_onset_kernel_equals_plain_version_at_path_shapes_and_waits(cuda, R, T, wait):
    # the content windows (3 s, 4 s), the calibration (one song, a chunk of 4, the 180 s song), a
    # row of whole rounds and one frame; a wait of 0 or less fires every candidate, one past T the first
    rng = np.random.default_rng(R * T)
    for density in (0.1, 0.5, 1.0):
        cand = torch.from_numpy(rng.random((R, T)) < density).to(cuda)
        got = _launched("onset_wait", lambda: tonset._wait(cand, wait))
        assert torch.equal(got, tonset._wait_plain(cand, wait)), density


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["random", "ties", "one NaN", "NaN row"])
def test_cuda_banded_viterbi_kernel_equals_plain_version(cuda, kind):
    log_v, log_u = (torch.from_numpy(a).to(cuda) for a in _pyin_obs(kind))
    got = _launched("banded_viterbi", lambda: tpyin._banded_viterbi(log_v, log_u, 5, 0.01))
    ref = tpyin._banded_viterbi_plain(log_v, log_u, 5, 0.01)
    assert all(torch.equal(g, r) for g, r in zip(got, ref))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["random", "ties", "one NaN", "NaN row"])
@pytest.mark.parametrize("B,T,S", [(3, 60, 7), (1, 301, 25), (4, 301, 25), (1, 1801, 25), (2, 300, 32), (2, 40, 1),
                                   (1, 1, 25), (2, 301, 33), (2, 301, 61), (1, 40, 1024)])
def test_cuda_dense_viterbi_kernel_equals_plain_version(cuda, kind, B, T, S):
    # up to 32 states the warp layout (the CRF's 25 at the 30 s bucket, a chunk of 4 and the 180 s song), then the block layout
    log_em, trans = (torch.from_numpy(a).to(cuda) for a in _emissions(kind, B, T, S))
    init = torch.full((S,), -float(np.log(S)), device=cuda)
    got = _launched("dense_viterbi", lambda: tvit.viterbi_log_dense(log_em, trans, init))
    ref = tvit.viterbi_log_dense_plain(log_em, trans, init)
    assert _same(got, ref)
    if kind == "NaN row" and B > 1:
        assert bool(got[1][1].isnan()) and not bool(got[1][0].isnan())
    one = _launched("dense_viterbi", lambda: tvit.viterbi_log_dense(log_em[0], trans, init))
    assert _same(one, (ref[0][0], ref[1][0]))


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["dbn [4, 3000]", "onset [80, 130]", "banded [20, 130, 241]", "dense [1, 301, 25]"])
def test_cuda_kernels_at_main_path_shapes(cuda, name):
    rng = np.random.default_rng(19)
    if name.startswith("dbn"):
        act = torch.from_numpy(rng.random((4, 3000)).astype(np.float32)).to(cuda)
        got = _launched("dbn_viterbi", lambda: tdbn._dbn_forward(act))
        ref = tdbn._dbn_forward_plain(act, 100, 55.0, 215.0, 100.0, 16)
    elif name.startswith("onset"):
        cand = torch.from_numpy(rng.random((80, 130)) < 0.3).to(cuda)
        got, ref = _launched("onset_wait", lambda: tonset._wait(cand, 4)), tonset._wait_plain(cand, 4)
    elif name.startswith("banded"):
        log_v, log_u = (torch.from_numpy(a).to(cuda) for a in _pyin_obs("random", R=20, T=130, n_bins=241))
        got = _launched("banded_viterbi", lambda: tpyin._banded_viterbi(log_v, log_u, 25, 0.01))
        ref = tpyin._banded_viterbi_plain(log_v, log_u, 25, 0.01)
    else:
        log_em, trans = (torch.from_numpy(a).to(cuda) for a in _emissions("random", B=1, T=301, S=25))
        init = torch.full((25,), -float(np.log(25)), device=cuda)
        got = _launched("dense_viterbi", lambda: tvit.viterbi_log_dense(log_em, trans, init))
        ref = tvit.viterbi_log_dense_plain(log_em, trans, init)
    assert all(torch.equal(g, r) for g, r in zip(got if isinstance(got, tuple) else (got,), ref if isinstance(ref, tuple) else (ref,)))


@pytest.mark.cuda
@pytest.mark.parametrize("min_bpm", [40.0, 55.0])
def test_cuda_dbn_kernel_equals_plain_version_on_both_layouts(cuda, min_bpm):
    # 55 BPM: the shipped grid (84 tempi, 110 phases, the layout with the
    # transitions in registers); 40 BPM: 124 tempi, 150 phases, the other layout
    act = torch.from_numpy(_activations("beats")).to(cuda)
    got = _launched("dbn_viterbi", lambda: tdbn._dbn_forward(act, min_bpm=min_bpm))
    ref = tdbn._dbn_forward_plain(act, 100, min_bpm, 215.0, 100.0, 16)
    assert all(torch.equal(g, r) for g, r in zip(got, ref))


@pytest.mark.cuda
@pytest.mark.parametrize("n_bins,band", [(301, 25), (700, 127), (1024, 1)])
def test_cuda_banded_viterbi_kernel_equals_plain_version_at_other_widths(cuda, n_bins, band):
    # 301 bins: the melody fallback's pYIN (C2 to C7); the widest band and the most bins the kernel takes
    for kind in ("random", "ties"):
        log_v, log_u = (torch.from_numpy(a).to(cuda) for a in _pyin_obs(kind, R=2, T=40, n_bins=n_bins))
        got = _launched("banded_viterbi", lambda: tpyin._banded_viterbi(log_v, log_u, band, 0.01))
        ref = tpyin._banded_viterbi_plain(log_v, log_u, band, 0.01)
        assert all(torch.equal(g, r) for g, r in zip(got, ref))


@pytest.mark.cuda
@pytest.mark.parametrize("grid", WIDE_GRIDS + [(25.0, 215.0, 100)], ids=lambda g: f"{g[0]:g}-{g[1]:g}bpm-{g[2]}fps")
@pytest.mark.parametrize("kind", ["random", "constant", "beats", "one NaN", "NaN row"])
def test_cuda_dbn_kernel_equals_plain_version_on_wide_tempo_grids(cuda, grid, kind):
    # every grid the JAX scan takes: 25 BPM at 100 fps (214 tempi x 240
    # phases) was refused before the general layout
    min_bpm, max_bpm, fps = grid
    act = torch.from_numpy(_activations(kind)).to(cuda)
    got = _launched("dbn_viterbi", lambda: tdbn._dbn_forward(act, fps=fps, min_bpm=min_bpm, max_bpm=max_bpm))
    ref = tdbn._dbn_forward_plain(act, fps, min_bpm, max_bpm, 100.0, 16)
    assert all(torch.equal(g, r) for g, r in zip(got, ref))


@pytest.mark.cuda
def test_cuda_dbn_launcher_refuses_more_tempi_than_shared_memory_holds(cuda):
    # 12,000 tempi: the general layout's five per-tempo vectors alone pass 227 KB;
    # the launcher refuses before it touches an argument
    n = P = 12_000
    args = [ctypes.c_void_p(0)] * 10 + [1, 2, n, P, n * P // 2, ctypes.c_void_p(0)]
    assert _build.function("dbn_viterbi", "dbn_viterbi_f32", tdbn._ARGTYPES)(*args) == -2


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["random", "equal columns", "at min + penalty", "one NaN", "NaN row"])
@pytest.mark.parametrize("B,S,T", [(1, 49, 301), (4, 49, 301), (1, 61, 301), (3, 25, 120), (2, 64, 40), (1, 49, 1801),
                                   (2, 7, 1), (2, 33, 70)])
def test_cuda_constant_switch_kernel_equals_plain_version(cuda, kind, B, S, T):
    # majmin7 (49 states) for one song, a chunk of 4 and the 180 s song; majmin7plus (61); one and two state words
    em = torch.from_numpy(_switch_emissions(kind, B, S, T)).to(cuda)
    penalty = float(-np.log(np.float32(0.5))) if kind == "at min + penalty" else 2.5
    got = _launched("constant_switch_viterbi", lambda: tvit.viterbi_constant_switch(em, penalty))
    ref = tvit.viterbi_constant_switch_plain(em, penalty)
    assert _same(got, ref)
    one = _launched("constant_switch_viterbi", lambda: tvit.viterbi_constant_switch(em[0], penalty))
    assert _same(one, (ref[0][0], ref[1][0]))


@pytest.mark.cuda
def test_cuda_constant_switch_kernel_refuses_too_many_states(cuda):
    with pytest.raises(ValueError, match="at most 64"):
        tvit.viterbi_constant_switch(torch.rand(1, 65, 10, device=cuda), 2.5)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["random", "constant", "negative", "loud then silent", "one NaN", "NaN row"])
@pytest.mark.parametrize("R,T", [(1, 2584), (4, 2584), (1, 15504), (2, 700), (1, 37), (3, 345), (2, 64), (1, 1)])
def test_cuda_salience_envelope_kernel_equals_plain_version(cuda, kind, R, T):
    # the 30 s bucket for one song and a chunk of 4, the 180 s song; whole and partial blocks, 16-byte and scalar loads
    sal = torch.from_numpy(_salience(kind, R, T)).to(cuda)
    got = _launched("salience_envelope", lambda: tbp.salience_envelope(sal))
    assert _same(got, tbp.salience_envelope_plain(sal))
    one = _launched("salience_envelope", lambda: tbp.salience_envelope(sal[0]))
    assert _same(one, got[0])
    if kind == "NaN row" and R > 1:
        assert bool(got[1].isnan().all()) and not bool(got[0].isnan().any())


@pytest.mark.cuda
def test_cuda_salience_envelope_kernel_on_a_row_off_16_bytes(cuda):
    # a contiguous view one float into its storage: T % 4 == 0 but the rows are off 16 bytes (the scalar loads)
    x = torch.from_numpy(_salience("random", 1, 2584)).to(cuda).reshape(-1)
    buf = torch.empty(x.numel() + 1, device=cuda)
    buf[1:] = x
    sal = buf[1:].view(1, 88, 2584)
    assert sal.is_contiguous() and sal.data_ptr() % 16
    got = _launched("salience_envelope", lambda: tbp.salience_envelope(sal))
    assert _same(got, tbp.salience_envelope_plain(sal))


@pytest.mark.cuda
def test_cuda_salience_envelope_kernel_on_two_streams_at_once(cuda):
    # each stream has its own block counters: launches queued behind a spin kernel on each of two streams, which then
    # overlap (two rows of the 180 s song are 244 blocks, so both streams' grids fit on the card at once), still give
    # the plain loop's envelopes; every launch has its own input, so that a stale scratch or output of an earlier
    # launch cannot pass for its result; a round may not overlap, so there are three
    base = [torch.from_numpy(_salience(kind, 2, 15504)).to(cuda) for kind in ("random", "loud then silent")]
    sal = [[x * (i + 1) for i in range(20)] for x in base]
    ref = [[tbp.salience_envelope_plain(x) for x in row] for row in sal]
    streams = [torch.cuda.Stream(cuda) for _ in base]
    for x, stream in zip(base, streams):  # the kernel built and loaded, each stream's counters made, before the queue
        with torch.cuda.stream(stream):
            tbp.salience_envelope(x)
    for round_ in range(3):
        torch.cuda.synchronize()
        for stream in streams:
            with torch.cuda.stream(stream):
                torch.cuda._sleep(10_000_000)
        out = [[], []]
        for i in range(20):
            for k, stream in enumerate(streams):
                with torch.cuda.stream(stream):
                    out[k].append(tbp.salience_envelope(sal[k][i]))
        torch.cuda.synchronize()
        for k in range(2):
            for i in range(20):
                assert _same(out[k][i], ref[k][i]), (round_, k, i)


@pytest.mark.cuda
def test_cuda_salience_envelope_kernel_refuses_a_stride_off_the_warp(cuda):
    # the kernel's blocks are 64 frames (ENVELOPE_STRIDE), two warps' segments unrolled
    for stride in (48, 96):
        with pytest.raises(ValueError, match="the kernel takes 64"):
            tbp.salience_envelope(torch.rand(1, 88, 100, device=cuda), stride=stride)

