"""The port's nets and decoders against the JAX package, on the same inputs and weights.

Each net runs once with its shipped npz checkpoint and once with the JAX
package's ``init_params`` pytree, both carried across by
audiotabs_tpu_torch/models/convert.py. Floats at rtol 1e-4 / atol 1e-5
(the f32 recurrence and convolutions sum in another order); decoded paths
exactly.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from audiotabs_tpu.decode import dbn_beats as jdbn
from audiotabs_tpu.decode import viterbi as jvit
from audiotabs_tpu.models import basicpitch as jbp
from audiotabs_tpu.models import beat_rnn as jbr
from audiotabs_tpu.models import crf_chords as jcrf
from audiotabs_tpu.models import deepchroma as jdc
from audiotabs_tpu.models import key_cnn as jkc
from audiotabs_tpu_torch.decode import dbn_beats as tdbn
from audiotabs_tpu_torch.decode import viterbi as tvit
from audiotabs_tpu_torch.models import basicpitch as tbp
from audiotabs_tpu_torch.models import beat_rnn as tbr
from audiotabs_tpu_torch.models import crf_chords as tcrf
from audiotabs_tpu_torch.models import deepchroma as tdc
from audiotabs_tpu_torch.models import key_cnn as tkc
from test_torch_fused import torch_threads  # noqa: F401 (an autouse fixture)

SR = 22050
TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(scope="module")
def audio():
    """3 s of a chord with a pulse every 0.5 s, plus noise, from a seed."""
    rng = np.random.default_rng(11)
    t = np.arange(3 * SR) / SR
    y = sum(0.2 * np.sin(2 * np.pi * f * t) for f in (196.0, 246.94, 293.66))
    y = y * (0.6 + 0.4 * np.exp(-8.0 * (t % 0.5)))
    return (y + 0.01 * rng.standard_normal(len(t))).astype(np.float32)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


# ---------------------------------------------------------------- beats ----


def test_beat_activation_real_ensemble_matches_jax(audio):
    params = jbr.load_params(jbr.default_weights_path())
    assert params is not None and len(params["ensemble"]) == 1
    ref = np.asarray(jbr.beat_activation(jnp.asarray(audio), SR, params=params))
    tparams = tbr.load_params()
    got = tbr.beat_activation(torch.from_numpy(audio), SR, tbr.ensemble_from_params(tparams))
    np.testing.assert_allclose(got.detach().numpy(), ref, **TOL)


def test_spectral_features_match_jax(audio):
    ref = np.asarray(jbr.spectral_features(jnp.asarray(audio), SR))
    np.testing.assert_allclose(tbr.spectral_features(torch.from_numpy(audio), SR).numpy(), ref, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("full_context", [False, True])
def test_blstm_init_params_chunked_and_full_context_match_jax(full_context):
    """Random pytrees; 600 frames so the chunked path runs several windows."""
    rng = np.random.default_rng(5)
    feats = rng.standard_normal((600, 12)).astype(np.float32)
    m0 = _np(jbr.init_params(jax.random.PRNGKey(0), 12, hidden=6, layers=2))
    m1 = _np(jbr.init_params(jax.random.PRNGKey(1), 12, hidden=6, layers=2))
    m0["feat_mean"], m0["feat_std"] = feats.mean(0), feats.std(0) + 0.5
    if full_context:
        m1["full_context"] = np.asarray(1)
    params = {**m0, "ensemble": [m1]}
    ensemble = tbr.ensemble_from_params(params)
    assert [m.full_context for m in ensemble] == [False, full_context]
    with torch.no_grad():
        got = torch.stack(
            [tbr.blstm_apply(m, torch.from_numpy(feats)) if m.full_context else tbr.blstm_apply_chunked(m, torch.from_numpy(feats)) for m in ensemble]
        ).mean(0)
    # the JAX ensemble average over the same features
    apply1 = jbr.blstm_apply if full_context else jbr.blstm_apply_chunked
    m1j = {k: v for k, v in m1.items() if k != "full_context"}
    ref = (np.asarray(jbr.blstm_apply_chunked(m0, jnp.asarray(feats))) + np.asarray(apply1(m1j, jnp.asarray(feats)))) / 2
    np.testing.assert_allclose(got.numpy(), ref, **TOL)


def test_dbn_forward_matches_jax_exactly(audio):
    rng = np.random.default_rng(2)
    t = np.arange(900)
    act = (0.05 + 0.9 * (t % 50 < 3) * rng.uniform(0.5, 1.0, len(t))).astype(np.float32)
    act[400:460] = 0.05  # a gap the bar pointer has to carry the tempo through
    ph_j, iv_j = (np.asarray(a) for a in jdbn._dbn_forward(jnp.asarray(act)))
    ph, iv = tdbn._dbn_forward(torch.from_numpy(act))
    np.testing.assert_array_equal(ph.numpy(), ph_j)
    np.testing.assert_array_equal(iv.numpy(), iv_j)
    np.testing.assert_array_equal(
        tdbn.beats_from_decoded(ph.numpy(), iv.numpy(), act), jdbn.beats_from_decoded(ph_j, iv_j, act)
    )


def test_dbn_tables_are_the_same_arrays():
    np.testing.assert_array_equal(tdbn._tempo_grid(55.0, 215.0, 100), jdbn._tempo_grid(55.0, 215.0, 100))
    np.testing.assert_array_equal(tdbn._tempo_transition(55.0, 215.0, 100, 100.0), jdbn._tempo_transition(55.0, 215.0, 100, 100.0))


# ------------------------------------------------------------- Basic Pitch --


@pytest.mark.parametrize("weights", ["npz", "init"])
def test_basicpitch_cnn_matches_jax(audio, weights):
    params = jbp.load_params() if weights == "npz" else _np(jbp.init_params(jax.random.PRNGKey(3)))
    hc = np.array(jbp.hcqt(jnp.asarray(audio[: 2 * SR]), SR))
    ref = [np.asarray(a) for a in jbp.cnn_apply(params, jnp.asarray(hc))]
    net = tbp.BasicPitchCNN.from_params(params)
    with torch.no_grad():
        got = tbp.cnn_apply(net, torch.from_numpy(hc))
    for g, r in zip(got, ref):
        assert g.shape == r.shape
        np.testing.assert_allclose(g.numpy(), r, **TOL)


def test_hcqt_and_salience_match_jax(audio):
    yj, y = jnp.asarray(audio[: 2 * SR]), torch.from_numpy(audio[: 2 * SR])
    ref = np.asarray(jbp.hcqt(yj, SR))
    np.testing.assert_allclose(tbp.hcqt(y, SR).numpy(), ref, rtol=1e-4, atol=1e-5 * ref.max())
    for g, r in zip(tbp.salience_posteriors(y, SR), jbp.salience_posteriors(yj, SR)):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-3, atol=1e-4)


def test_population_std_is_the_jnp_std():
    """Parity trap: jnp.std is the population std; torch.std defaults to n-1."""
    x = np.arange(6, dtype=np.float32)
    assert np.isclose(torch.from_numpy(x).std(correction=0).item(), float(jnp.std(jnp.asarray(x))))
    assert not np.isclose(torch.from_numpy(x).std().item(), float(jnp.std(jnp.asarray(x))))


@pytest.mark.parametrize("size,kernel,stride", [(264, 7, 3), (264, 5, 3), (88, 4, 1), (30, 39, 1)])
def test_same_padding_matches_lax(size, kernel, stride):
    x = np.random.default_rng(size).standard_normal((1, size, 9, 1)).astype(np.float32)
    w = np.random.default_rng(kernel).standard_normal((kernel, 3, 1, 2)).astype(np.float32)
    ref = jax.lax.conv_general_dilated(jnp.asarray(x), jnp.asarray(w), (stride, 1), "SAME", dimension_numbers=("NHWC", "HWIO", "NHWC"))
    conv = tbp.SameConv2d(1, 2, (kernel, 3), stride=(stride, 1), bias=False)
    conv.weight.data = torch.from_numpy(np.transpose(w, (3, 2, 0, 1)).copy())
    with torch.no_grad():
        got = conv(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


# ----------------------------------------------------------- chords, key ---


@pytest.mark.parametrize("weights", ["npz", "init"])
def test_deepchroma_matches_jax(audio, weights):
    feats = np.array(jdc.features(jnp.asarray(audio), SR))
    np.testing.assert_allclose(tdc.features(torch.from_numpy(audio), SR).numpy(), feats, rtol=1e-4, atol=1e-4)
    params = jdc.load_params() if weights == "npz" else _np(jdc.init_params(jax.random.PRNGKey(4), feats.shape[1]))
    ref = np.asarray(jdc.apply(params, jnp.asarray(feats)))
    with torch.no_grad():
        got = tdc.apply(tdc.DeepChromaDNN.from_params(params), torch.from_numpy(feats))
    np.testing.assert_allclose(got.numpy(), ref, **TOL)


@pytest.mark.parametrize("weights", ["npz", "init"])
def test_key_cnn_with_mask_matches_jax(audio, weights):
    feats = np.array(jkc.features(jnp.asarray(audio), SR))
    np.testing.assert_allclose(tkc.features(torch.from_numpy(audio), SR).numpy(), feats, rtol=1e-4, atol=1e-4)
    params = jkc.load_params() if weights == "npz" else _np(jkc.init_params(jax.random.PRNGKey(5)))
    net = tkc.KeyCNN.from_params(params)
    mask = np.arange(feats.shape[0]) < feats.shape[0] - 4
    for m in (None, mask):
        ref = np.asarray(jkc.apply(params, jnp.asarray(feats), None if m is None else jnp.asarray(m)))
        with torch.no_grad():
            got = tkc.apply(net, torch.from_numpy(feats), None if m is None else torch.from_numpy(m))
        np.testing.assert_allclose(got.numpy(), ref, **TOL)


@pytest.mark.parametrize("params_kind", ["template", "context"])
def test_crf_decode_matches_jax_and_gates_silence_to_n(params_kind):
    rng = np.random.default_rng(9)
    feats = np.abs(rng.standard_normal((80, 12))).astype(np.float32)
    feats[30:40] = 0.0  # gated frames
    if params_kind == "template":
        params = jcrf.template_emission_params()
    else:  # a trained-style emission over a 3-frame context window
        params = _np(jcrf.init_params(jax.random.PRNGKey(6), feature_dim=36))
    path_j, conf_j = (np.asarray(a) for a in jcrf.decode(params, jnp.asarray(feats)))
    path, conf = tcrf.decode(_np(params), torch.from_numpy(feats))
    np.testing.assert_array_equal(path.numpy(), path_j)
    assert path.dtype == torch.int32 and (path[30:40] == 0).all()
    np.testing.assert_allclose(conf.numpy(), conf_j, **TOL)


def test_viterbi_decoders_match_jax_exactly_with_ties():
    """Parity trap: argmax/argmin must return the first extremum on ties."""
    rng = np.random.default_rng(4)
    em = rng.random((6, 50)).astype(np.float32)
    em[:, 10:20] = 0.5  # exact ties across every state
    em /= em.sum(0)
    p_j, c_j = (np.asarray(a) for a in jvit.viterbi_constant_switch(jnp.asarray(em), 2.5))
    p, c = tvit.viterbi_constant_switch(torch.from_numpy(em), 2.5)
    np.testing.assert_array_equal(p.numpy(), p_j)
    np.testing.assert_allclose(c.numpy(), c_j, **TOL)
    log_em = np.log(em.T)
    trans = np.log(np.full((6, 6), 1.0 / 6, np.float32))
    p_j, s_j = jvit.viterbi_log_dense(jnp.asarray(log_em), jnp.asarray(trans))
    p, s = tvit.viterbi_log_dense(torch.from_numpy(log_em), torch.from_numpy(trans))
    np.testing.assert_array_equal(p.numpy(), np.asarray(p_j))
    np.testing.assert_allclose(s.item(), float(s_j), rtol=1e-5)


def test_template_emission_params_are_the_same_arrays():
    j, t = jcrf.template_emission_params(), tcrf.template_emission_params()
    for k in j:
        np.testing.assert_array_equal(t[k], np.asarray(j[k]))
    assert tcrf.LABELS == jcrf.LABELS
