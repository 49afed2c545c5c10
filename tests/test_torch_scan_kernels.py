"""The last two lax.scans of the JAX package, in the port: the template
backend's constant-switch Viterbi (decode/viterbi.py) and the salience
envelope of ``salience_posteriors`` (models/basicpitch.py).

On the card each is one launch of a CUDA kernel (csrc/constant_switch_viterbi.cu,
csrc/salience_envelope.cu), held bit-equal to its plain version by
tests/test_torch_decoder_kernels.py and chip_smoke.py. Here the plain
versions, which a CPU tensor takes, are held against the JAX package on
inputs made from numpy seeds: the Viterbi path exactly (confidences within
TOL) at the chord vocabularies' widths, with ties at every frame of some
stretches and costs exactly at min + penalty; the salience posteriors of a
clip of 14 envelope blocks, loud then quiet so that the decay and the floor
both act, within the tolerance of tests/test_torch_models.py; both on NaN
inputs (NaN positions and paths equal). The posteriors from the caller's
hCQT, and of a batch of rows, equal those computed per song.

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_scan_kernels.py
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from audiotabs_tpu.decode import viterbi as jvit
from audiotabs_tpu.models import basicpitch as jbp
from audiotabs_tpu_torch import tracing
from audiotabs_tpu_torch.decode import viterbi as tvit
from audiotabs_tpu_torch.models import basicpitch as tbp
from test_torch_decoder_kernels import _salience, _switch_emissions
from test_torch_fused import torch_threads  # noqa: F401 (an autouse fixture)

SR = 22050
TOL = dict(rtol=1e-4, atol=1e-5)
SALIENCE_TOL = dict(rtol=1e-3, atol=1e-4)  # as tests/test_torch_models.py::test_hcqt_and_salience_match_jax
PENALTY = float(-np.log(np.float32(0.5)))  # the cost of an emission of 0.5: ties with min + penalty


# ---- the constant-switch Viterbi -----------------------------------------


@pytest.mark.parametrize("S", [49, 61])
@pytest.mark.parametrize("kind", ["random", "equal columns", "at min + penalty"])
def test_constant_switch_plain_matches_jax_exactly(S, kind):
    em = _switch_emissions(kind, B=1, S=S, T=301)[0]
    penalty = PENALTY if kind == "at min + penalty" else 2.5
    p_j, c_j = (np.asarray(a) for a in jvit.viterbi_constant_switch(jnp.asarray(em), penalty))
    p, c = tvit.viterbi_constant_switch(torch.from_numpy(em), penalty)
    assert p.dtype == torch.int32 and p.shape == c.shape == (301,)
    np.testing.assert_array_equal(p.numpy(), p_j)
    np.testing.assert_allclose(c.numpy(), c_j, **TOL)


def test_constant_switch_tie_cases_hold_ties():
    """The tie-heavy inputs really tie: some frame's costs all equal, and
    some state's cost equals the minimum plus the penalty, so the ``<=``
    that keeps a tie on its state decides."""
    for kind, penalty in (("equal columns", 2.5), ("at min + penalty", PENALTY)):
        em = torch.from_numpy(_switch_emissions(kind, B=1, S=49, T=301)[0])
        logp = -torch.log(torch.clamp(em, 1e-9, 1.0))
        dp, ties = logp[:, 0], 0
        for t in range(1, em.shape[1]):
            sw = dp.min() + penalty
            ties += int(((dp == sw) & (dp > dp.min())).sum())
            dp = torch.minimum(dp, sw) + logp[:, t]
        if kind == "equal columns":
            assert (logp == logp[:1]).all(dim=0).any()
        else:
            assert ties > 0


@pytest.mark.parametrize("kind", ["random", "equal columns", "at min + penalty"])
def test_batched_constant_switch_plain_matches_jax_row_by_row(kind):
    em = _switch_emissions(kind, B=3, S=25, T=120)
    penalty = PENALTY if kind == "at min + penalty" else 2.5
    path, conf = tvit.viterbi_constant_switch(torch.from_numpy(em), penalty)
    assert path.shape == conf.shape == (3, 120) and path.dtype == torch.int32
    for b in range(len(em)):
        p_j, c_j = (np.asarray(a) for a in jvit.viterbi_constant_switch(jnp.asarray(em[b]), penalty))
        np.testing.assert_array_equal(path[b].numpy(), p_j, err_msg=f"{kind} row {b}")
        np.testing.assert_allclose(conf[b].numpy(), c_j, **TOL)
        p1, c1 = tvit.viterbi_constant_switch(torch.from_numpy(em[b]), penalty)
        assert torch.equal(p1, path[b]) and torch.equal(c1, conf[b])


@pytest.mark.parametrize("S,T", [(1, 40), (25, 1), (7, 2)])
def test_constant_switch_plain_matches_jax_at_the_edges(S, T):
    em = _switch_emissions("random", B=1, S=S, T=T)[0]
    p_j, c_j = (np.asarray(a) for a in jvit.viterbi_constant_switch(jnp.asarray(em), 2.5))
    p, c = tvit.viterbi_constant_switch(torch.from_numpy(em), 2.5)
    np.testing.assert_array_equal(p.numpy(), p_j)
    np.testing.assert_allclose(c.numpy(), c_j, **TOL)


# ---- the salience envelope -----------------------------------------------


def _loud_then_quiet(seconds: float = 10.0, loud: float = 4.0) -> np.ndarray:
    """Chords of harmonic tones: loud for ``loud`` seconds, then 24 dB quieter."""
    t = np.arange(int(seconds * SR)) / SR
    y = np.zeros_like(t)
    for f0, start in ((196.0, 0.0), (246.9, 0.0), (293.7, 2.0), (220.0, loud), (261.6, loud + 2.5), (329.6, loud + 4.0)):
        gain = 0.8 if start < loud else 0.05
        on = (t >= start) & (t < (start + 2.5 if start < loud else seconds))
        for h in range(1, 5):
            y += on * gain / h * np.sin(2 * np.pi * f0 * h * t)
    noise = np.random.default_rng(21).standard_normal(len(t)) * 1e-3
    return ((y + noise) / 4).astype(np.float32)


def test_salience_posteriors_match_jax_over_many_blocks():
    audio = _loud_then_quiet()
    y = torch.from_numpy(audio)
    ref = [np.asarray(a) for a in jbp.salience_posteriors(jnp.asarray(audio), SR)]
    got = tbp.salience_posteriors(y, SR)
    n_frames = got[1].shape[0]
    assert -(-n_frames // tbp.ENVELOPE_STRIDE) >= 12
    for g, r in zip(got, ref):
        assert g.shape == r.shape
        np.testing.assert_allclose(g.numpy(), r, **SALIENCE_TOL)
    # the decay and the floor both act on this clip: the envelope is above
    # the block maxima after the loud part, and at the floor at its end
    hc = tbp.hcqt(y, SR)
    A = hc / (hc[1].max() + 1e-8)
    sal = (A[1] * (1.0 + sum(0.9 ** (i - 1) * A[i] for i in range(2, len(tbp.HARMONICS))))
           * (1.0 - 0.5 * torch.clamp(A[0] - A[1], 0.0, 1.0)))
    sal = sal.reshape(tbp.N_SEMITONES, tbp.BINS_PER_SEMITONE, -1).max(dim=1).values
    norm = tbp.salience_envelope(sal)
    m = torch.nn.functional.pad(sal, (0, norm.numel() * tbp.ENVELOPE_STRIDE - sal.shape[-1]))
    m = m.reshape(tbp.N_SEMITONES, -1, tbp.ENVELOPE_STRIDE).amax(dim=(0, 2))
    floor = tbp.ENVELOPE_FLOOR * sal.max()
    assert (norm > torch.maximum(m, floor)).any() and (norm == floor).any()


def test_salience_posteriors_split_at_the_hcqt_and_the_salience():
    """The fused analysis computes the hCQT it gives the CNN once, and takes
    the posteriors from it through ``salience_from_hcqt`` and
    ``posteriors_from_salience``: the posteriors of ``salience_posteriors``,
    per song or as a batch of rows of one length."""
    y = torch.from_numpy(_loud_then_quiet(seconds=3.0))
    own = tbp.salience_posteriors(y, SR)
    sal = tbp.salience_from_hcqt(tbp.hcqt(y, SR))
    rows = tbp.posteriors_from_salience(torch.stack([sal, 0.5 * sal, sal.flip(-1)]))
    for r, x in enumerate((sal, 0.5 * sal, sal.flip(-1))):
        assert all(torch.equal(a[r], b) for a, b in zip(rows, tbp.posteriors_from_salience(x))), r
    assert all(torch.equal(a, b) for a, b in zip(own, tbp.posteriors_from_salience(sal)))


@jax.jit
def _jax_envelope(sal):
    """The JAX package's envelope of ``salience_posteriors``
    (audiotabs_tpu/models/basicpitch.py:190-203), from the block maxima to the floor."""
    stride, decay = 64, 0.6
    T = sal.shape[-1]
    nblk = max(1, -(-T // stride))
    s_pad = jnp.pad(sal, ((0, 0), (0, nblk * stride - T)))
    m = s_pad.reshape(sal.shape[0], nblk, stride).max(axis=(0, 2))

    def _env(carry, x):
        e = jnp.maximum(x, decay * carry)
        return e, e

    _, fwd = jax.lax.scan(_env, 0.0, m)
    _, bwd = jax.lax.scan(_env, 0.0, m, reverse=True)
    return jnp.maximum(jnp.maximum(fwd, bwd), 0.05 * jnp.max(sal))


@pytest.mark.parametrize("kind", ["random", "constant", "negative", "loud then silent"])
@pytest.mark.parametrize("T", [700, 640, 37])
def test_salience_envelope_plain_is_the_jax_envelope(kind, T):
    sal = _salience(kind, R=3, T=T)
    got = tbp.salience_envelope(torch.from_numpy(sal))
    assert got.shape == (3, max(1, -(-T // 64)))
    for r in range(len(sal)):
        np.testing.assert_array_equal(got[r].numpy(), np.asarray(_jax_envelope(jnp.asarray(sal[r]))), err_msg=f"{kind} row {r}")
        assert torch.equal(tbp.salience_envelope(torch.from_numpy(sal[r])), got[r])


@pytest.mark.parametrize("kind", ["one NaN", "NaN row"])
def test_plain_versions_match_jax_on_nans(kind):
    """A NaN emission (its cost a NaN) wins the minimum and spreads to every
    later frame, as in jnp.min and jnp.argmin; a NaN salience makes its row's
    envelope NaN (the floor is NaN), as jnp.maximum and jnp.max propagate it:
    NaN positions equal, the paths equal."""
    em = _switch_emissions(kind, B=3, S=49, T=301)
    path, conf = tvit.viterbi_constant_switch(torch.from_numpy(em), 2.5)
    assert conf.isnan().any()
    for b in range(len(em)):
        p_j, c_j = (np.asarray(a) for a in jvit.viterbi_constant_switch(jnp.asarray(em[b]), 2.5))
        np.testing.assert_array_equal(path[b].numpy(), p_j, err_msg=f"{kind} row {b}")
        np.testing.assert_array_equal(conf[b].isnan().numpy(), np.isnan(c_j))
        np.testing.assert_allclose(conf[b].numpy(), c_j, **TOL)
    sal = _salience(kind, R=3, T=700)
    got = tbp.salience_envelope(torch.from_numpy(sal))
    assert got.isnan().any() and not got[min(2, len(sal) - 1)].isnan().any()
    for r in range(len(sal)):
        np.testing.assert_array_equal(got[r].numpy(), np.asarray(_jax_envelope(jnp.asarray(sal[r]))), err_msg=f"{kind} row {r}")


def test_wrappers_on_a_cpu_tensor_take_the_plain_version(monkeypatch):
    calls = []
    for mod, name in ((tbp, "salience_envelope_plain"), (tvit, "viterbi_constant_switch_plain")):
        fn = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, fn=fn, name=name: calls.append(name) or fn(*a))
    names = ("salience_envelope_launches", "constant_switch_viterbi_launches", "dense_viterbi_launches")
    before = [tracing.counters().get(n, 0) for n in names]
    tbp.salience_envelope(torch.from_numpy(_salience("random", R=1, T=200)[0]))
    tvit.viterbi_constant_switch(torch.from_numpy(_switch_emissions("random", B=1, S=25, T=30)[0]), 2.5)
    assert calls == ["salience_envelope_plain", "viterbi_constant_switch_plain"]
    assert [tracing.counters().get(n, 0) for n in names] == before


@pytest.mark.parametrize(
    "call",
    [lambda x: tbp.salience_envelope(x), lambda x: tvit.viterbi_constant_switch(x, 2.5)],
    ids=["salience_envelope", "constant_switch"],
)
def test_wrappers_raise_on_a_device_that_is_neither_cuda_nor_cpu(call):
    with pytest.raises(ValueError, match="cuda or cpu"):
        call(torch.rand(2, 30, 70, device="meta"))


@pytest.mark.parametrize(
    "call",
    [lambda x: tbp.salience_envelope(x), lambda x: tvit.viterbi_constant_switch(x, 2.5)],
    ids=["salience_envelope", "constant_switch"],
)
def test_wrappers_refuse_other_ranks(call):
    with pytest.raises(ValueError, match="takes"):
        call(torch.rand(2, 3, 4, 5))
