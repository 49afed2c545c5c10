"""The four decoder kernels against their plain loops, on the card.

``_dbn_forward``, the onset wait rule, ``_banded_viterbi`` and
``viterbi_log_dense`` launch csrc/dbn_viterbi.cu, onset_wait.cu,
banded_viterbi.cu and dense_viterbi.cu for a CUDA tensor; each launch must
add one to its module's count and give exactly the plain loop's output, on
random and tie-heavy inputs made from numpy seeds (the same inputs
tests/test_torch_decoders.py holds the plain loops against the JAX package
with). Every test here is ``cuda``-marked and skips without a card. The file
imports no JAX, so it also runs where only PyTorch is installed:

    python -m pytest --noconftest tests/test_torch_decoder_kernels.py -m cuda
"""

from __future__ import annotations

import importlib

import numpy as np
import pytest
import torch

from audiotabs_tpu_torch.decode import dbn_beats as tdbn
from audiotabs_tpu_torch.decode import viterbi as tvit
from audiotabs_tpu_torch.ops import onset as tonset

# the ops package re-exports the pyin function under the module's name
tpyin = importlib.import_module("audiotabs_tpu_torch.ops.pyin")


# ---- inputs --------------------------------------------------------------


def _activations(kind: str, B: int = 3, T: int = 400) -> np.ndarray:
    rng = np.random.default_rng(7)
    t = np.arange(T)
    if kind == "random":
        return rng.random((B, T)).astype(np.float32)
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
    if kind == "random":
        obs = rng.random((R, T, n_bins)).astype(np.float32)
        obs /= obs.sum(-1, keepdims=True) * rng.uniform(1.0, 3.0, (R, T, 1))
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
    return np.log(em).astype(np.float32), np.log(trans).astype(np.float32)


# ---- on the card ---------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the decoder kernels have no CPU mode")
    return torch.device("cuda")


def _launched(module, fn):
    before = module.LAUNCHES
    out = fn()
    torch.cuda.synchronize()
    assert module.LAUNCHES == before + 1
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["random", "constant", "beats"])
def test_cuda_dbn_kernel_equals_plain_version(cuda, kind):
    act = torch.from_numpy(_activations(kind)).to(cuda)
    got = _launched(tdbn, lambda: tdbn._dbn_forward(act))
    ref = tdbn._dbn_forward_plain(act, 100, 55.0, 215.0, 100.0, 16)
    assert all(torch.equal(g, r) for g, r in zip(got, ref))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["random", "plateaus"])
def test_cuda_onset_kernel_equals_plain_version(cuda, kind):
    env = torch.from_numpy(_envelopes(kind)).to(cuda)
    cand = env >= env.mean(dim=-1, keepdim=True)
    got = _launched(tonset, lambda: tonset._wait(cand, 4))
    assert torch.equal(got, tonset._wait_plain(cand, 4))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["random", "ties"])
def test_cuda_banded_viterbi_kernel_equals_plain_version(cuda, kind):
    log_v, log_u = (torch.from_numpy(a).to(cuda) for a in _pyin_obs(kind))
    got = _launched(tpyin, lambda: tpyin._banded_viterbi(log_v, log_u, 5, 0.01))
    ref = tpyin._banded_viterbi_plain(log_v, log_u, 5, 0.01)
    assert all(torch.equal(g, r) for g, r in zip(got, ref))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["random", "ties"])
def test_cuda_dense_viterbi_kernel_equals_plain_version(cuda, kind):
    log_em, trans = (torch.from_numpy(a).to(cuda) for a in _emissions(kind))
    init = torch.full((log_em.shape[-1],), -float(np.log(log_em.shape[-1])), device=cuda)
    got = _launched(tvit, lambda: tvit.viterbi_log_dense(log_em, trans, init))
    ref = tvit.viterbi_log_dense_plain(log_em, trans, init)
    assert all(torch.equal(g, r) for g, r in zip(got, ref))


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["dbn [4, 3000]", "onset [80, 130]", "banded [20, 130, 241]", "dense [1, 301, 25]"])
def test_cuda_kernels_at_main_path_shapes(cuda, name):
    rng = np.random.default_rng(19)
    if name.startswith("dbn"):
        act = torch.from_numpy(rng.random((4, 3000)).astype(np.float32)).to(cuda)
        got = _launched(tdbn, lambda: tdbn._dbn_forward(act))
        ref = tdbn._dbn_forward_plain(act, 100, 55.0, 215.0, 100.0, 16)
    elif name.startswith("onset"):
        cand = torch.from_numpy(rng.random((80, 130)) < 0.3).to(cuda)
        got, ref = _launched(tonset, lambda: tonset._wait(cand, 4)), tonset._wait_plain(cand, 4)
    elif name.startswith("banded"):
        log_v, log_u = (torch.from_numpy(a).to(cuda) for a in _pyin_obs("random", R=20, T=130, n_bins=241))
        got = _launched(tpyin, lambda: tpyin._banded_viterbi(log_v, log_u, 25, 0.01))
        ref = tpyin._banded_viterbi_plain(log_v, log_u, 25, 0.01)
    else:
        log_em, trans = (torch.from_numpy(a).to(cuda) for a in _emissions("random", B=1, T=301, S=25))
        init = torch.full((25,), -float(np.log(25)), device=cuda)
        got = _launched(tvit, lambda: tvit.viterbi_log_dense(log_em, trans, init))
        ref = tvit.viterbi_log_dense_plain(log_em, trans, init)
    assert all(torch.equal(g, r) for g, r in zip(got if isinstance(got, tuple) else (got,), ref if isinstance(ref, tuple) else (ref,)))


@pytest.mark.cuda
@pytest.mark.parametrize("min_bpm", [40.0, 55.0])
def test_cuda_dbn_kernel_equals_plain_version_on_both_layouts(cuda, min_bpm):
    # 55 BPM: the shipped grid (84 tempi, 110 phases, the layout with the
    # transitions in registers); 40 BPM: 124 tempi, 150 phases, the other layout
    act = torch.from_numpy(_activations("beats")).to(cuda)
    got = _launched(tdbn, lambda: tdbn._dbn_forward(act, min_bpm=min_bpm))
    ref = tdbn._dbn_forward_plain(act, 100, min_bpm, 215.0, 100.0, 16)
    assert all(torch.equal(g, r) for g, r in zip(got, ref))


@pytest.mark.cuda
@pytest.mark.parametrize("n_bins,band", [(301, 25), (700, 127), (1024, 1)])
def test_cuda_banded_viterbi_kernel_equals_plain_version_at_other_widths(cuda, n_bins, band):
    # 301 bins: the melody fallback's pYIN (C2 to C7); the widest band and the most bins the kernel takes
    for kind in ("random", "ties"):
        log_v, log_u = (torch.from_numpy(a).to(cuda) for a in _pyin_obs(kind, R=2, T=40, n_bins=n_bins))
        got = _launched(tpyin, lambda: tpyin._banded_viterbi(log_v, log_u, band, 0.01))
        ref = tpyin._banded_viterbi_plain(log_v, log_u, band, 0.01)
        assert all(torch.equal(g, r) for g, r in zip(got, ref))


@pytest.mark.cuda
def test_cuda_dbn_score_too_large_for_shared_memory_raises(cuda):
    # 25 BPM at 100 fps: 214 tempi x 240 phases, two scores of 411 KB
    with pytest.raises(ValueError, match="shared memory"):
        tdbn._dbn_forward(torch.rand(1, 50, device=cuda), min_bpm=25.0)
