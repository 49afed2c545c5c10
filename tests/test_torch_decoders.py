"""The port's four sequential decoders against the JAX package's lax.scans.

``_dbn_forward`` (decode/dbn_beats.py), the wait rule of
``onset_detect_frames`` (ops/onset.py), ``_banded_viterbi`` (ops/pyin.py) and
``viterbi_log_dense`` (decode/viterbi.py) each launch a CUDA kernel for a
CUDA tensor and take a plain loop, batched over a leading axis, for a CPU
tensor. Here the plain versions run on batches made from numpy seeds, random
and tie-heavy (a constant DBN activation, plateaued onset envelopes, equal
emission columns), and each row must equal the JAX function's output on that
row: every integer and boolean exactly, the dense Viterbi's final score
within rtol 1e-6 (the same float32 additions in the same order; the bound
only allows for XLA's fusion). The 1-D / 2-D forms must equal the batched
form. The dense Viterbi's loop follows jnp on a NaN too: the first NaN is
the maximum, and the score is NaN. The kernels are held bit-equal to the
plain versions on the card by chip_smoke.py and by
tests/test_torch_decoder_kernels.py; their wrappers' limits raise here,
before a launch, on tensors of the ``meta`` device (shapes without memory).
"""

from __future__ import annotations

import ctypes
import importlib
import types

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from audiotabs_tpu.decode import dbn_beats as jdbn
from audiotabs_tpu.decode import viterbi as jvit
from audiotabs_tpu.models import crf_chords as jcrf
from audiotabs_tpu.ops import onset as jonset
from audiotabs_tpu_torch import _build
from audiotabs_tpu_torch.decode import dbn_beats as tdbn
from audiotabs_tpu_torch.decode import viterbi as tvit
from audiotabs_tpu_torch.models import basicpitch as tbp
from audiotabs_tpu_torch.models import crf_chords as tcrf
from audiotabs_tpu_torch.ops import median as tmed
from audiotabs_tpu_torch.ops import onset as tonset
from test_torch_decoder_kernels import WIDE_GRIDS, _activations, _emissions, _envelopes, _pyin_obs
from test_torch_fused import torch_threads  # noqa: F401 (an autouse fixture)

# both ops packages re-export the pyin function under the module's name
jpyin = importlib.import_module("audiotabs_tpu.ops.pyin")
tpyin = importlib.import_module("audiotabs_tpu_torch.ops.pyin")

SCORE_RTOL = 1e-6
SOURCES = ("dbn_viterbi", "onset_wait", "banded_viterbi", "dense_viterbi", "salience_envelope", "constant_switch_viterbi")


# ---- DBN -----------------------------------------------------------------


@pytest.mark.parametrize("kind", ["random", "constant", "beats"])
def test_batched_dbn_plain_matches_jax_row_by_row(kind):
    act = _activations(kind)
    ph, iv = tdbn._dbn_forward(torch.from_numpy(act))
    assert ph.shape == iv.shape == act.shape and ph.dtype == iv.dtype == torch.int32
    for b in range(len(act)):
        ph_j, iv_j = jdbn._dbn_forward(jnp.asarray(act[b]))
        np.testing.assert_array_equal(ph[b].numpy(), np.asarray(ph_j), err_msg=f"{kind} row {b} phases")
        np.testing.assert_array_equal(iv[b].numpy(), np.asarray(iv_j), err_msg=f"{kind} row {b} intervals")


def test_dbn_one_song_is_the_batch_of_one():
    act = _activations("beats", B=2)
    ph, iv = tdbn._dbn_forward(torch.from_numpy(act))
    for b in range(2):
        ph1, iv1 = tdbn._dbn_forward(torch.from_numpy(act[b]))
        assert ph1.shape == (act.shape[1],)
        assert torch.equal(ph1, ph[b]) and torch.equal(iv1, iv[b])
        ph_b1, iv_b1 = tdbn._dbn_forward(torch.from_numpy(act[b : b + 1]))
        assert torch.equal(ph_b1[0], ph[b]) and torch.equal(iv_b1[0], iv[b])


def test_dbn_beat_track_matches_jax():
    act = _activations("beats", B=1)[0]
    np.testing.assert_array_equal(tdbn.dbn_beat_track(act, device="cpu"), jdbn.dbn_beat_track(act))


@pytest.mark.parametrize("grid", WIDE_GRIDS[:3], ids=lambda g: f"{g[0]:g}-{g[1]:g}bpm-{g[2]}fps")
@pytest.mark.parametrize("kind", ["random", "constant", "beats", "one NaN", "NaN row"])
def test_dbn_plain_equals_jax_on_wide_tempo_grids(grid, kind):
    # tempo grids past the kernel's register layouts (its general layout on the card)
    min_bpm, max_bpm, fps = grid
    act = _activations(kind, B=2, T=300)
    ph, iv = tdbn._dbn_forward(torch.from_numpy(act), fps=fps, min_bpm=min_bpm, max_bpm=max_bpm)
    for b in range(len(act)):
        ph_j, iv_j = jdbn._dbn_forward(jnp.asarray(act[b]), fps=fps, min_bpm=min_bpm, max_bpm=max_bpm)
        np.testing.assert_array_equal(ph[b].numpy(), np.asarray(ph_j), err_msg=f"{kind} row {b} phases")
        np.testing.assert_array_equal(iv[b].numpy(), np.asarray(iv_j), err_msg=f"{kind} row {b} intervals")


def test_dbn_kernel_limits_raise_before_a_launch():
    # 1,000 fps gives 813 tempi x 1,091 phases: the wrapper refuses no grid
    # (the general layout takes any); its arguments hold the score scratch,
    # one float a valid state, for where the score does not fit shared memory
    args = tdbn._launch_args(torch.empty((2, 10), device="meta"), 1000, 55.0, 215.0, 100.0, 16)
    grid = tdbn._tempo_grid(55.0, 215.0, 1000)
    assert len(grid) == 813 and args[0].shape == (2, 813, 1091)
    assert args[7].shape == (2, int(grid.sum())) and args[-2].shape == args[-1].shape == (2, 10)
    # the launcher owns the layout: its codes for per-tempo vectors that do
    # not fit shared memory, and for arguments out of range, raise
    # ValueError; a cudaError raises RuntimeError
    with pytest.raises(ValueError, match="shared memory"):
        _build.check_launch(-2, "dbn_viterbi", tdbn._REFUSED)
    with pytest.raises(ValueError, match="out of range"):
        _build.check_launch(-1, "dbn_viterbi", tdbn._REFUSED)
    with pytest.raises(RuntimeError, match="cudaError 700"):
        _build.check_launch(700, "dbn_viterbi", tdbn._REFUSED)
    _build.check_launch(0, "dbn_viterbi", tdbn._REFUSED)


# ---- onset wait rule -----------------------------------------------------


@pytest.mark.parametrize("kind", ["random", "plateaus"])
@pytest.mark.parametrize("delta,wait", [(0.5, 4), (0.07, 3), (0.0, 0)])
def test_batched_onset_plain_matches_jax_row_by_row(kind, delta, wait):
    env = _envelopes(kind)
    got = tonset.onset_detect_frames(torch.from_numpy(env), delta=delta, wait=wait)
    assert got.dtype == torch.bool and got.shape == env.shape
    for b in range(len(env)):
        ref = np.asarray(jonset.onset_detect_frames(jnp.asarray(env[b]), delta=delta, wait=wait))
        np.testing.assert_array_equal(got[b].numpy(), ref, err_msg=f"{kind} row {b}")
    # the 1-D form and a [2, 2, T] batch are the same rows
    for b in range(len(env)):
        assert torch.equal(tonset.onset_detect_frames(torch.from_numpy(env[b]), delta=delta, wait=wait), got[b])
    assert torch.equal(tonset.onset_detect_frames(torch.from_numpy(env.reshape(2, 2, -1)), delta=delta, wait=wait),
                       got.reshape(2, 2, -1))


def test_wait_rule_takes_bool_candidates():
    with pytest.raises(TypeError):
        tonset._wait(torch.zeros(3, 5, dtype=torch.uint8), 3)


@pytest.mark.parametrize("wait", [0, 4])
def test_onset_plain_matches_jax_at_the_long_songs_length(wait):
    # the calibration envelope of a 180 s song: [1, 7752] frames at hop 512
    env = np.random.default_rng(23).random((1, 7752)).astype(np.float32)
    got = tonset.onset_detect_frames(torch.from_numpy(env), delta=0.5, wait=wait)
    ref = np.asarray(jonset.onset_detect_frames(jnp.asarray(env[0]), delta=0.5, wait=wait))
    np.testing.assert_array_equal(got[0].numpy(), ref)
    assert 0 < ref.sum() < ref.size


@pytest.mark.parametrize("wait", [-10**12, -5, -1, 0, 1, 7, 129, 130, 131, 10**12])
def test_onset_kernel_wait_is_the_same_rule(wait):
    # the wait the kernel is given, clamped into a C int, fires the same frames as the wait asked for
    cand = torch.from_numpy(np.random.default_rng(29).random((4, 130)) < 0.4)
    kernel_wait = tonset._kernel_wait(wait, 130)
    assert -1 <= kernel_wait <= 130
    assert torch.equal(tonset._wait_plain(cand, kernel_wait), tonset._wait_plain(cand, wait))


def test_onset_kernel_limits_raise_before_a_launch():
    # meta tensors: shapes without memory, so nothing is allocated or launched
    with pytest.raises(ValueError, match="2\\*\\*31"):
        tonset._launch_args(torch.empty((1, 2**31), dtype=torch.bool, device="meta"), 4)
    with pytest.raises(ValueError, match="2\\*\\*31"):
        tonset._launch_args(torch.empty((2**31, 1), dtype=torch.bool, device="meta"), 4)
    with pytest.raises(TypeError):
        tonset._launch_args(torch.empty((2, 130), dtype=torch.bool, device="meta"), 2.5)
    cand, fired, wait = tonset._launch_args(torch.empty((2, 130), dtype=torch.bool, device="meta"), 10**12)
    assert cand.shape == fired.shape == (2, 130) and wait == 130


# ---- pYIN banded Viterbi -------------------------------------------------


@pytest.mark.parametrize("kind", ["random", "ties"])
@pytest.mark.parametrize("band,switch_prob", [(5, 0.01), (1, 0.3)])
def test_batched_banded_viterbi_plain_matches_jax_row_by_row(kind, band, switch_prob):
    log_v, log_u = _pyin_obs(kind)
    bins, voiced = tpyin._banded_viterbi(torch.from_numpy(log_v), torch.from_numpy(log_u), band, switch_prob)
    assert bins.shape == voiced.shape == log_v.shape[:2] and voiced.dtype == torch.bool
    for r in range(len(log_v)):
        b_j, v_j = jpyin._banded_viterbi(jnp.asarray(log_v[r]), jnp.asarray(log_u[r]), band, switch_prob)
        np.testing.assert_array_equal(bins[r].numpy(), np.asarray(b_j), err_msg=f"{kind} row {r} bins")
        np.testing.assert_array_equal(voiced[r].numpy(), np.asarray(v_j), err_msg=f"{kind} row {r} voiced")


def test_banded_viterbi_one_row_and_two_lead_axes_are_the_batch():
    log_v, log_u = _pyin_obs("random", R=4)
    bins, voiced = tpyin._banded_viterbi(torch.from_numpy(log_v), torch.from_numpy(log_u), 5, 0.01)
    b2, v2 = tpyin._banded_viterbi(torch.from_numpy(log_v.reshape(2, 2, *log_v.shape[1:])),
                                   torch.from_numpy(log_u.reshape(2, 2, *log_u.shape[1:])), 5, 0.01)
    assert torch.equal(b2.reshape(bins.shape), bins) and torch.equal(v2.reshape(voiced.shape), voiced)
    # pyin passes the unvoiced evidence as a broadcast view
    u_view = torch.from_numpy(np.ascontiguousarray(log_u[0, :, :1])).expand(-1, log_u.shape[-1])
    b1, v1 = tpyin._banded_viterbi(torch.from_numpy(log_v[0]), u_view, 5, 0.01)
    assert torch.equal(b1, bins[0]) and torch.equal(v1, voiced[0])


# ---- dense Viterbi -------------------------------------------------------


@pytest.mark.parametrize("kind", ["random", "ties"])
@pytest.mark.parametrize("with_initial", [False, True])
def test_batched_dense_viterbi_plain_matches_jax_row_by_row(kind, with_initial):
    log_em, trans = _emissions(kind)
    init = np.log(np.linspace(1.0, 2.0, log_em.shape[-1]) / np.linspace(1.0, 2.0, log_em.shape[-1]).sum()).astype(np.float32)
    init_t = torch.from_numpy(init) if with_initial else None
    path, score = tvit.viterbi_log_dense(torch.from_numpy(log_em), torch.from_numpy(trans), init_t)
    assert path.shape == log_em.shape[:2] and path.dtype == torch.int32 and score.shape == (len(log_em),)
    for b in range(len(log_em)):
        args = (jnp.asarray(log_em[b]), jnp.asarray(trans)) + ((jnp.asarray(init),) if with_initial else ())
        p_j, s_j = jvit.viterbi_log_dense(*args)
        np.testing.assert_array_equal(path[b].numpy(), np.asarray(p_j), err_msg=f"{kind} row {b}")
        np.testing.assert_allclose(score[b].item(), float(s_j), rtol=SCORE_RTOL)
        p1, s1 = tvit.viterbi_log_dense(torch.from_numpy(log_em[b]), torch.from_numpy(trans), init_t)
        assert torch.equal(p1, path[b]) and torch.equal(s1, score[b])


@pytest.mark.parametrize("kind", ["one NaN", "NaN row"])
def test_dense_viterbi_plain_follows_jax_on_nan(kind):
    # jnp.max and jnp.argmax take the first NaN for the maximum, as torch's do: the path runs
    # into the NaN's state, then state 0; the score is NaN
    log_em, trans = _emissions(kind, B=3, T=40, S=25)
    path, score = tvit.viterbi_log_dense(torch.from_numpy(log_em), torch.from_numpy(trans))
    nan_rows = {0} if kind == "one NaN" else {1}
    for b in range(len(log_em)):
        p_j, s_j = jvit.viterbi_log_dense(jnp.asarray(log_em[b]), jnp.asarray(trans))
        np.testing.assert_array_equal(path[b].numpy(), np.asarray(p_j), err_msg=f"{kind} row {b}")
        assert bool(np.isnan(float(s_j))) == bool(score[b].isnan()) == (b in nan_rows)
        if b not in nan_rows:
            np.testing.assert_allclose(score[b].item(), float(s_j), rtol=SCORE_RTOL)
    if kind == "one NaN":
        # the NaN at frame T // 3 in state S // 2: the path runs into it, and every later frame,
        # all NaN, decodes as state 0 (the first NaN)
        assert path[0, 40 // 3] == 25 // 2 and (path[0, 40 // 3 + 1 :] == 0).all()


def test_dense_viterbi_kernel_limits_raise_before_a_launch():
    trans, init = torch.empty((1025, 1025), device="meta"), torch.empty((1025,), device="meta")
    with pytest.raises(ValueError, match="at most 1024 states"):
        tvit._launch_args(torch.empty((1, 10, 1025), device="meta"), trans, init)
    with pytest.raises(ValueError, match="2\\*\\*31"):
        tvit._launch_args(torch.empty((1, 2**22, 1024), device="meta"), trans[:1024, :1024], init[:1024])
    # up to 32 states the records are padded to a warp's 32 lanes
    args = tvit._launch_args(torch.empty((4, 301, 25), device="meta"), trans[:25, :25], init[:25])
    assert args[3].shape == (4, 300, 2, 32) and args[4].shape == (4, 301) and args[5].shape == (4,)
    assert tvit._launch_args(torch.empty((2, 1, 61), device="meta"), trans[:61, :61], init[:61])[3].shape == (2, 1, 2, 61)


# ---- the CRF decode of a batch -------------------------------------------


def _crf_feats(B: int = 3, T: int = 50, D: int = 12) -> np.ndarray:
    """Chroma-like features with silent (all-zero) frames, as the fused analysis gates them."""
    rng = np.random.default_rng(37)
    f = rng.random((B, T, D)).astype(np.float32)
    f /= np.linalg.norm(f, axis=-1, keepdims=True)
    f[:, ::7] = 0.0
    f[1, 30:] = 0.0
    return f


@pytest.mark.parametrize("params", ["templates", "context"])
def test_crf_decode_of_a_batch_is_its_rows(params):
    # each row's path exactly; its confidences within rtol 1e-6 of the row's own (torch's CPU exp
    # takes a vector or a scalar path by an element's place in the tensor, an ulp apart) and of JAX's
    if params == "templates":
        p = tcrf.template_emission_params()
    else:  # a trained-style head over 3 stacked context frames, scaled so that the emissions decide
        p = tcrf.init_params(torch.Generator().manual_seed(3), feature_dim=36)
        p["emit_w"] = p["emit_w"] * np.float32(30.0)
    feats = _crf_feats()
    path, conf = tcrf.decode(p, torch.from_numpy(feats))
    assert path.shape == conf.shape == feats.shape[:2] and path.dtype == torch.int32
    for b in range(len(feats)):
        p1, c1 = tcrf.decode(p, torch.from_numpy(feats[b]))
        assert torch.equal(p1, path[b])
        torch.testing.assert_close(c1, conf[b], rtol=1e-6, atol=0.0)
        p_j, c_j = jcrf.decode({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(feats[b]))
        np.testing.assert_array_equal(path[b].numpy(), np.asarray(p_j), err_msg=f"row {b}")
        np.testing.assert_allclose(conf[b].numpy(), np.asarray(c_j), rtol=1e-5, atol=1e-7)
    assert (path[1, 30:] == 0).all()
    with pytest.raises(ValueError, match="\\[B, T, D\\]"):
        tcrf.decode(p, torch.from_numpy(feats[0, 0]))


# ---- wrappers and the build ----------------------------------------------


@pytest.mark.parametrize(
    "call",
    [
        lambda x: tdbn._dbn_forward(x[0]),
        lambda x: tonset.onset_detect_frames(x[0]),
        lambda x: tpyin._banded_viterbi(x, x, 5, 0.01),
        lambda x: tvit.viterbi_log_dense(x, x[0, :8, :8]),
        lambda x: tmed.median_filter(x, 5),
        lambda x: tbp.salience_envelope(x),
        lambda x: tvit.viterbi_constant_switch(x, 2.5),
    ],
    ids=["dbn", "onset", "banded_viterbi", "dense_viterbi", "median", "salience_envelope", "constant_switch_viterbi"],
)
def test_wrappers_raise_on_a_device_that_is_neither_cuda_nor_cpu(call):
    with pytest.raises(ValueError, match="cuda or cpu"):
        call(torch.rand(2, 30, 40, device="meta"))


@pytest.mark.parametrize("name", SOURCES)
def test_build_knows_each_decoder_source(name):
    src = _build.PACKAGE_DIR / "csrc" / f"{name}.cu"
    path = _build.library_path(name)
    assert src.exists() and path.parent == _build.BUILD_DIR and path.name.startswith(f"{name}-")
    text = src.read_text()
    # the note names the lax.scan it replaces; no launcher checks fewer errors than cudaGetLastError
    assert "Replaces the " in text and "audiotabs_tpu/" in text and "cudaGetLastError()" in text
    assert not any("fast_math" in flag or "fast-math" in flag for flag in _build.NVCC_FLAGS)


def test_build_function_loads_each_symbol_once(monkeypatch):
    # the loaded launcher is cached, and generated headers are made only for the first load
    loads, made = [], []

    def load(name, headers=None):
        loads.append((name, headers))
        return types.SimpleNamespace(launch_f32=types.SimpleNamespace())

    def headers():
        made.append(1)
        return {"gen.h": "// generated"}

    monkeypatch.setattr(_build, "load", load)
    monkeypatch.setattr(_build, "_FUNCS", {})
    first = _build.function("fake", "launch_f32", [ctypes.c_void_p, ctypes.c_int], headers)
    assert _build.function("fake", "launch_f32", [ctypes.c_void_p, ctypes.c_int], headers) is first
    assert loads == [("fake", {"gen.h": "// generated"})] and made == [1]
    assert first.argtypes == [ctypes.c_void_p, ctypes.c_int] and first.restype is ctypes.c_int


def test_fused_batch_decodes_every_song_in_one_dbn_call(monkeypatch):
    from audiotabs_tpu_torch.runtime import fused

    calls = []
    dbn = fused._dbn_forward

    def counted(act, *args, **kwargs):
        calls.append(tuple(act.shape))
        return dbn(act, *args, **kwargs)

    monkeypatch.setattr(fused, "_dbn_forward", counted)
    rng = np.random.default_rng(5)
    y = torch.from_numpy((0.1 * rng.standard_normal((2, 22050))).astype(np.float32))
    with torch.inference_mode():
        out = fused.fused_analysis_batch(y, 22050, separate=True, chord_backend="deep")
    assert calls == [(2, out["beat_activation"].shape[-1])]
    assert out["dbn_phases"].dtype == out["dbn_intervals"].dtype == torch.int32
    with torch.inference_mode():
        for b in range(2):
            one = fused.fused_analysis(y[b], 22050, separate=True, chord_backend="deep")
            for k in ("dbn_phases", "dbn_intervals", "crf_path"):
                assert torch.equal(one[k], out[k][b]), k


def test_fused_batch_decodes_every_song_in_one_crf_call(monkeypatch):
    from audiotabs_tpu_torch.runtime import fused

    calls = []
    decode = tvit.viterbi_log_dense

    def counted(log_em, *args, **kwargs):
        calls.append(tuple(log_em.shape))
        return decode(log_em, *args, **kwargs)

    monkeypatch.setattr(tcrf, "viterbi_log_dense", counted)
    rng = np.random.default_rng(41)
    y = torch.from_numpy((0.1 * rng.standard_normal((3, 22050))).astype(np.float32))
    with torch.inference_mode():
        out = fused.fused_analysis_batch(y, 22050, chord_backend="deep", true_lens=[22050, 15000, 9000])
    assert calls == [(3, out["crf_path"].shape[-1], tcrf.N_STATES)]
    assert "crf_features" not in out and out["crf_path"].dtype == torch.int32
    calls.clear()
    with torch.inference_mode():
        for b, n in enumerate((22050, 15000, 9000)):
            one = fused.fused_analysis(y[b], 22050, chord_backend="deep", true_len=n)
            assert torch.equal(one["crf_path"], out["crf_path"][b])
            # an ulp apart at most: torch's CPU exp takes a vector or a scalar path by an element's place
            torch.testing.assert_close(one["crf_conf"], out["crf_conf"][b], rtol=1e-6, atol=0.0)
    assert calls == [(1, out["crf_path"].shape[-1], tcrf.N_STATES)] * 3


def test_cached_nets_built_in_inference_mode_stay_usable_with_autograd():
    """The first ``load_models`` call may come from inside inference mode (the
    fused analysis runs there); the nets it caches must still run with
    autograd on, as a trainer or the beat fallback's test runs them."""
    from audiotabs_tpu_torch.models.beat_rnn import beat_activation
    from audiotabs_tpu_torch.runtime import fused

    fused.load_models.cache_clear()
    try:
        with torch.inference_mode():
            nets = fused.load_models(torch.device("cpu"))
        assert nets.beat and not any(p.is_inference() for m in nets.beat for p in m.parameters())
        y = torch.from_numpy((0.1 * np.random.default_rng(3).standard_normal(22050)).astype(np.float32))
        assert torch.isfinite(beat_activation(y, 22050, nets.beat, 100)).all()
    finally:
        fused.load_models.cache_clear()


def test_cached_dbn_grid_survives_in_place_ops_and_autograd():
    """The DBN's tempo-grid tensors are built once per device
    (``_device_grid``), here first from inside inference mode. They must be
    normal tensors (an autograd call may save them), copies of the
    ``lru_cache``d numpy arrays, and a call's own tensors (observations,
    initial score, the kernel's buffers) must be fresh, so a caller's
    in-place op on them leaves the grid, and every later decode, as it was."""
    args = (100, 55.0, 215.0, 100.0, 16)
    cpu = torch.device("cpu")
    act = torch.from_numpy(_activations("beats", B=2))
    tdbn._device_grid.cache_clear()
    try:
        with torch.inference_mode():
            first = tdbn._dbn_forward(act)
        grid = tdbn._device_grid(55.0, 215.0, 100, 100.0, 16, cpu)
        assert not any(t.is_inference() for t in grid)
        assert not np.shares_memory(grid.log_trans.numpy(), tdbn._tempo_transition(55.0, 215.0, 100, 100.0))
        assert not np.shares_memory(grid.intervals.numpy(), tdbn._tempo_grid(55.0, 215.0, 100))

        f = tdbn._forward_inputs(act, *args)
        launch = tdbn._launch_args(act, *args)
        shared = [t for t in launch if any(t is g for g in grid)]
        assert len(shared) == 3  # the transition matrix and the int32 intervals and beat windows, read only
        for t in (f.lo_beat, f.lo_off, f.init, *(t for t in launch if not any(t is g for g in grid))):
            t.fill_(-3)
        weights = torch.ones_like(grid.log_trans, requires_grad=True)
        (weights * grid.log_trans).sum().backward()
        assert torch.equal(weights.grad, grid.log_trans)

        fresh = tdbn._device_grid.__wrapped__(55.0, 215.0, 100, 100.0, 16, cpu)
        assert all(torch.equal(a, b) for a, b in zip(grid, fresh))
        again = tdbn._dbn_forward(act)
        assert all(torch.equal(a, b) for a, b in zip(first, again))
    finally:
        tdbn._device_grid.cache_clear()
