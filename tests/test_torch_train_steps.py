"""The port's training steps against the JAX trainers' (train/*_train.py), on the CPU.

Both sides start from the JAX ``init_params`` carried across
(models/convert.py) and take the same batch. Tolerances:

- the loss: rtol 1e-5 (1e-4 for htdemucs);
- every gradient leaf within 1e-4 of that leaf's max |grad|. A leaf whose
  exact gradient is zero is held to 1e-9 of the largest gradient instead:
  the attention key biases of htdemucs (a softmax does not see a shift of
  all its logits), whose gradients are float noise (about 1e-11) in both
  packages;
- three optimizer steps against optax's, every leaf within 1e-5 of its max
  |value|. Each step both optimizers apply the JAX gradients: Adam moves an
  entry by about its rate whatever the gradient's size, so an entry whose
  gradient is float noise would otherwise move either way in the two
  packages. The port's own ``update`` (backward, zeroed normalisation
  gradients, frozen ``bias_hh``) is held in ``test_port_update_*``.

The deepchroma dropout masks are drawn with numpy and given to both losses.
The weights: a JAX init carried to the port's module and back is exact, and
a checkpoint written by the port's save functions loads in the JAX package's
loaders with the same leaves and the same forward.
"""

from functools import lru_cache, partial

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

import audiotabs_tpu.models.basicpitch as jbp
import audiotabs_tpu.models.beat_rnn as jbr
import audiotabs_tpu.models.crf_chords as jcc
import audiotabs_tpu.models.deepchroma as jdc
import audiotabs_tpu.models.htdemucs as jhd
import audiotabs_tpu.models.key_cnn as jkc
from audiotabs_tpu_torch.models import basicpitch, beat_rnn, convert, crf_chords, deepchroma, htdemucs, key_cnn
from audiotabs_tpu_torch.train import basicpitch_train, beat_rnn_train, crf_chords_train, deepchroma_train
from audiotabs_tpu_torch.train import htdemucs_train, key_cnn_train
from audiotabs_tpu_torch.train.optim import Trainer, cosine_decay
from test_torch_fused import torch_threads  # noqa: F401 (an autouse fixture)

CPU = torch.device("cpu")


def _np(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32) if np.asarray(a).dtype != np.int64 else np.asarray(a), tree)


def _init(module, key: int, **kw) -> dict:
    """A JAX ``init_params`` pytree as numpy, traced once (eagerly each random
    draw compiles on its own) and compiled without XLA's backend
    optimisations, which take most of the compile time of a run made once."""
    k = jax.random.PRNGKey(key)
    init = jax.jit(partial(module.init_params, **kw)).lower(k).compile(compiler_options={"xla_backend_optimization_level": 0})
    return _np(init(k))


@lru_cache(maxsize=1)
def _jax_tiny_htdemucs() -> dict:
    return _init(jhd, 0, n_sources=2, channels=8, bottom=64, t_layers=2)


def _tiny_htdemucs() -> dict:
    params = _jax_tiny_htdemucs()
    rng = np.random.default_rng(0)

    def redraw(node):  # LayerScale gains in [0.2, 0.8], so that every residual branch moves the output
        if isinstance(node, list):
            return [redraw(v) for v in node]
        if isinstance(node, dict):
            return {k: rng.uniform(0.2, 0.8, v.shape).astype(np.float32) if k in ("scale", "gamma1", "gamma2") else redraw(v)
                    for k, v in node.items()}
        return node

    return redraw(params)


def _grads(state_fn, template, net: torch.nn.Module) -> dict:
    """The gradients of ``net``'s parameters in ``template``'s pytree layout (zeros where there is none)."""
    zeros = jax.tree.map(lambda a: np.zeros(np.shape(a), np.float32), template)
    grads = {k: p.grad if p.grad is not None else torch.zeros_like(p) for k, p in net.named_parameters()}
    return convert.to_pytree(state_fn, zeros, {**{k: torch.zeros_like(v) for k, v in net.state_dict().items()}, **grads})


def _assert_grads(got: dict, ref: dict, zero_leaves: tuple[str, ...] = ()):
    g_max = max(float(np.abs(np.asarray(r)).max()) for r in jax.tree.leaves(ref))
    for (path, r), g in zip(jax.tree_util.tree_flatten_with_path(ref)[0], jax.tree.leaves(got)):
        r = np.asarray(r)
        name = jax.tree_util.keystr(path)
        scale = 1e-5 * g_max if any(f"'{z}'" in name for z in zero_leaves) else float(np.abs(r).max())
        np.testing.assert_allclose(g, r, rtol=0, atol=1e-4 * scale + 1e-30, err_msg=name)


def _assert_params(got: dict, ref: dict):
    for (path, r), g in zip(jax.tree_util.tree_flatten_with_path(ref)[0], jax.tree.leaves(got)):
        r = np.asarray(r)
        np.testing.assert_allclose(g, r, rtol=0, atol=1e-5 * float(np.abs(r).max()) + 1e-30, err_msg=jax.tree_util.keystr(path))


def _run_parity(state_fn, params, jax_loss, batch, jax_opt, port_loss, net, trainer, *, loss_rtol, zero_leaves=(),
                zero_grads=()):
    """The loss and gradients from the same params, then three optimizer steps on the JAX gradients.

    ``jax_loss(p, *batch)`` is jitted with the batch as arguments (as a
    closure constant XLA would constant-fold the hCQT convolution)."""
    vg = jax.jit(jax.value_and_grad(jax_loss))

    @jax.jit
    def apply(p, grads, opt_state):
        updates, opt_state = jax_opt.update(grads, opt_state, p)
        return optax.apply_updates(p, updates), opt_state

    jp = jax.tree.map(jnp.asarray, params)
    opt_state = jax_opt.init(jp)
    loss_t = port_loss(net)
    loss_t.backward()
    for step in range(3):
        loss_j, grads_j = vg(jp, *batch)
        if step == 0:
            np.testing.assert_allclose(float(loss_t.detach()), float(loss_j), rtol=loss_rtol, err_msg="loss")
            _assert_grads(_grads(state_fn, params, net), jax.device_get(grads_j), zero_leaves)
        grads_j = dict(grads_j)
        for k in zero_grads:  # the JAX trainers zero the normalisation statistics' gradients
            grads_j[k] = jnp.zeros_like(grads_j[k])
        state_grads = state_fn(jax.device_get(grads_j))
        for name, p in net.named_parameters():
            if p.requires_grad:
                p.grad = state_grads[name].clone()
        trainer.step()
        jp, opt_state = apply(jp, grads_j, opt_state)
    _assert_params(convert.to_pytree(state_fn, params, net.state_dict()), jax.device_get(jp))


def test_cosine_schedule_is_optax():
    for lr, steps, alpha in ((3e-4, 10, 0.1), (2e-3, 7, 0.05)):
        f = cosine_decay(steps, alpha)
        sched = optax.cosine_decay_schedule(lr, steps, alpha=alpha)
        np.testing.assert_allclose([lr * f(i) for i in range(steps + 3)], [float(sched(i)) for i in range(steps + 3)], rtol=1e-6)
    # the first update takes schedule(0), the second schedule(1)
    w = torch.nn.Parameter(torch.zeros(1))
    tr = Trainer([w], 1.0, 4, alpha=0.0)
    assert tr.opt.param_groups[0]["lr"] == 1.0
    w.grad = torch.ones(1)
    tr.step()
    assert tr.opt.param_groups[0]["lr"] == pytest.approx(cosine_decay(4, 0.0)(1))


def test_htdemucs_step_matches_jax():
    params = _tiny_htdemucs()
    rng = np.random.default_rng(1)
    sb = (0.1 * rng.standard_normal((2, 2, 2, 8192))).astype(np.float32)
    sb[1, 0] = 0.0  # a silent stem, as solo arrangements have
    mb = sb.sum(axis=1)

    def jax_loss(p, mb, sb):  # audiotabs_tpu/train/htdemucs_train.py:193-206
        pred = jax.vmap(lambda m: jhd.forward(p, m, n_sources=2))(mb)
        err = jnp.abs(pred - sb).mean(axis=(2, 3))
        level = jnp.abs(sb).mean(axis=(2, 3)) + 0.02
        recon = jnp.abs(pred.sum(axis=1) - mb).mean()
        return (err / level).mean() + 2.0 * recon

    net = htdemucs_train.trainable(params, CPU)
    _run_parity(convert.htdemucs_state, params, jax_loss, (mb, sb),
                optax.adam(optax.cosine_decay_schedule(3e-4, 10, alpha=0.1)),
                lambda n: htdemucs_train.loss_fn(n, torch.from_numpy(mb), torch.from_numpy(sb)),
                net, Trainer(net.parameters(), 3e-4, 10, alpha=0.1), loss_rtol=1e-4, zero_leaves=("k_b",))


@pytest.fixture(scope="module")
def blstm_case():
    rng = np.random.default_rng(2)
    xb = rng.standard_normal((4, 40, 12)).astype(np.float32)
    yb = (rng.uniform(size=(4, 40)) < 0.1).astype(np.float32)
    params = _init(jbr, 3, input_dim=12, hidden=8)
    params["feat_mean"] = xb.reshape(-1, 12).mean(axis=0)
    params["feat_std"] = xb.reshape(-1, 12).std(axis=0) + 1e-3
    return params, xb, yb


def test_beat_rnn_step_matches_jax(blstm_case):
    params, xb, yb = blstm_case

    def jax_loss(p, xb, yb):  # audiotabs_tpu/train/beat_rnn_train.py:210-215
        act = jnp.clip(jax.vmap(lambda x: jbr.blstm_apply(p, x))(xb), 1e-6, 1 - 1e-6)
        return (-(18.0 * yb * jnp.log(act) + (1 - yb) * jnp.log(1 - act))).mean()

    net = beat_rnn_train.trainable(params, CPU)
    _run_parity(convert.beat_blstm_state, params, jax_loss, (xb, yb),
                optax.adam(optax.cosine_decay_schedule(2e-3, 12, alpha=0.05)),
                lambda n: beat_rnn_train.loss_fn(n, torch.from_numpy(xb), torch.from_numpy(yb), 18.0),
                net, Trainer([p for p in net.parameters() if p.requires_grad], 2e-3, 12, alpha=0.05),
                loss_rtol=1e-5, zero_grads=("feat_mean", "feat_std"))


def test_port_update_beat_rnn_freezes_what_jax_does(blstm_case):
    params, xb, yb = blstm_case
    net = beat_rnn_train.trainable(params, CPU)
    trainer = Trainer([p for p in net.parameters() if p.requires_grad], 2e-3, 12, alpha=0.05)
    w0 = net.lstm.weight_ih_l0.detach().clone()
    loss = beat_rnn_train.update(net, trainer, torch.from_numpy(xb), torch.from_numpy(yb), 18.0)
    assert torch.isfinite(loss) and not torch.equal(net.lstm.weight_ih_l0, w0)
    assert all(float(p.abs().max()) == 0.0 for n, p in net.lstm.named_parameters() if n.startswith("bias_hh"))
    # Adam with a zeroed gradient leaves the statistics as they were
    np.testing.assert_array_equal(net.feat_mean.detach().numpy(), params["feat_mean"])
    np.testing.assert_array_equal(net.feat_std.detach().numpy(), params["feat_std"])


def test_key_cnn_step_matches_jax():
    rng = np.random.default_rng(4)
    xb = np.abs(rng.standard_normal((3, 16, 120, 1))).astype(np.float32)
    yb = np.asarray([0, 7, 21], np.int32)
    params = _init(jkc, 5, n_bands=120)

    def jax_loss(p, xb, yb):  # audiotabs_tpu/train/key_cnn_train.py:116-124
        probs = jnp.clip(jax.vmap(lambda f: jkc.apply(p, f))(xb), 1e-6, 1.0)
        logp = jnp.log(probs)
        nll = -logp[jnp.arange(xb.shape[0]), yb]
        return ((1 - 0.1) * nll - 0.1 * logp.mean(axis=1)).mean()

    net = key_cnn.KeyCNN.from_params(params)
    _run_parity(convert.key_cnn_state, params, jax_loss, (xb, yb),
                optax.adamw(optax.cosine_decay_schedule(2e-3, 9, alpha=0.05), weight_decay=1e-4),
                lambda n: key_cnn_train.loss_fn(n, torch.from_numpy(xb), torch.from_numpy(yb)),
                net, Trainer(net.parameters(), 2e-3, 9, alpha=0.05, weight_decay=1e-4), loss_rtol=1e-5)


@pytest.fixture(scope="module")
def deepchroma_case():
    rng = np.random.default_rng(6)
    xb = np.abs(rng.standard_normal((16, 60))).astype(np.float32)
    yb = (rng.uniform(size=(16, 12)) < 0.25).astype(np.float32)
    params = _init(jdc, 7, input_dim=60)
    params["feat_mean"] = xb.mean(axis=0)
    params["feat_std"] = xb.std(axis=0) + 1e-3
    masks = [(rng.uniform(size=(16, 512)) < 0.7).astype(np.float32) for _ in range(3)]
    return params, xb, yb, masks


def test_deepchroma_step_matches_jax(deepchroma_case):
    params, xb, yb, masks = deepchroma_case

    def jax_loss(p, xb, yb, masks):  # audiotabs_tpu/train/deepchroma_train.py:148-158, the masks given
        x = (xb - p["feat_mean"]) / p["feat_std"]
        for layer, keep in zip(p["layers"], masks):
            x = jax.nn.relu(x @ layer["w"] + layer["b"])
            x = x * keep / 0.7
        pred = jnp.clip(jax.nn.sigmoid(x @ p["out_w"] + p["out_b"]), 1e-6, 1 - 1e-6)
        return -(2.0 * yb * jnp.log(pred) + (1 - yb) * jnp.log(1 - pred)).mean()

    net = deepchroma_train.trainable(params, CPU)
    keep = [torch.from_numpy(m) for m in masks]
    _run_parity(convert.deepchroma_state, params, jax_loss, (xb, yb, masks),
                optax.adamw(optax.cosine_decay_schedule(1e-3, 8, alpha=0.05), weight_decay=1e-4),
                lambda n: deepchroma_train.loss_fn(n, torch.from_numpy(xb), torch.from_numpy(yb), keep),
                net, Trainer(net.parameters(), 1e-3, 8, alpha=0.05, weight_decay=1e-4),
                loss_rtol=1e-5, zero_grads=("feat_mean", "feat_std"))


def test_port_update_deepchroma_decays_the_statistics(deepchroma_case):
    """optax.adamw decays every leaf: the statistics, with zeroed gradients, shrink by lr·wd."""
    params, xb, yb, masks = deepchroma_case
    net = deepchroma_train.trainable(params, CPU)
    trainer = Trainer(net.parameters(), 1e-3, 8, alpha=0.05, weight_decay=1e-4)
    deepchroma_train.update(net, trainer, torch.from_numpy(xb), torch.from_numpy(yb), [torch.from_numpy(m) for m in masks])
    np.testing.assert_allclose(net.feat_mean.detach().numpy(), params["feat_mean"] * (1 - 1e-3 * 1e-4), rtol=1e-7)
    gen = torch.Generator().manual_seed(0)
    drawn = deepchroma_train.dropout_masks(net, 4000, gen)
    assert [tuple(m.shape) for m in drawn] == [(4000, 512)] * 3
    assert abs(float(drawn[0].mean()) - 0.7) < 0.01


def test_crf_step_matches_jax():
    rng = np.random.default_rng(8)
    xb = rng.standard_normal((64, 36)).astype(np.float32)
    yb = rng.integers(0, 25, size=64).astype(np.int32)
    w0 = crf_chords_train.template_init(3)

    def jax_loss(p, xb, yb):  # audiotabs_tpu/train/crf_chords_train.py:311-313
        logp = jax.nn.log_softmax(xb @ p["w"], axis=-1)
        return -logp[jnp.arange(xb.shape[0]), yb].mean()

    w = torch.nn.Parameter(torch.from_numpy(w0.copy()))
    holder = torch.nn.Module()
    holder.w = w

    def state(tree):
        return {"w": torch.from_numpy(np.array(tree["w"], np.float32))}

    _run_parity(state, {"w": w0}, jax_loss, (xb, yb),
                optax.adam(optax.cosine_decay_schedule(1e-2, 20, alpha=0.05)),
                lambda n: crf_chords_train.loss_fn(n.w, torch.from_numpy(xb), torch.from_numpy(yb)),
                holder, Trainer([w], 1e-2, 20, alpha=0.05), loss_rtol=1e-5)


def test_basicpitch_step_matches_jax():
    rng = np.random.default_rng(9)
    n = 11025
    yb = (0.2 * rng.standard_normal((2, n))).astype(np.float32)
    n_frames = n // basicpitch.HOP + 1
    rolls = [basicpitch_train.rolls_from_events([(0.05, 0.3, 60 + 7 * i), (0.2, 0.45, 45 + i)], n_frames) for i in range(2)]
    ob, fb, cb = (np.stack([r[k] for r in rolls]) for k in range(3))
    params = _init(jbp, 10)

    def jax_loss(p, yb, ob, fb, cb):  # audiotabs_tpu/train/basicpitch_train.py:137-150
        def one(y, o_t, f_t, c_t):
            onset, frame, contour = jbp.cnn_apply(p, jbp.hcqt(y, 22050))
            T = min(onset.shape[0], o_t.shape[0])
            onset = jnp.clip(onset[:T], 1e-6, 1 - 1e-6)
            frame = jnp.clip(frame[:T], 1e-6, 1 - 1e-6)
            contour = jnp.clip(contour[:T], 1e-6, 1 - 1e-6)
            o_t, f_t, c_t = o_t[:T], f_t[:T], c_t[:T]
            bce_o = -(12.0 * o_t * jnp.log(onset) + (1 - o_t) * jnp.log(1 - onset))
            bce_f = -(4.0 * f_t * jnp.log(frame) + (1 - f_t) * jnp.log(1 - frame))
            bce_c = -(4.0 * c_t * jnp.log(contour) + (1 - c_t) * jnp.log(1 - contour))
            return bce_o.mean() + bce_f.mean() + 2.0 * bce_c.mean()

        return jax.vmap(one)(yb, ob, fb, cb).mean()

    net = basicpitch.BasicPitchCNN.from_params(params)
    batch = tuple(torch.from_numpy(a) for a in (yb, ob, fb, cb))
    _run_parity(basicpitch._conv_state, params, jax_loss, (yb, ob, fb, cb),
                optax.adam(optax.cosine_decay_schedule(3e-3, 10, alpha=0.05)),
                lambda n: basicpitch_train.loss_fn(n, *batch),
                net, Trainer(net.parameters(), 3e-3, 10, alpha=0.05), loss_rtol=1e-5)


# ------------------------------------------------------------------ weights --


def _same_leaves(a: dict, b: dict):
    la, lb = jax.tree_util.tree_flatten_with_path(a)[0], jax.tree_util.tree_flatten_with_path(b)[0]
    assert [p for p, _ in la] == [p for p, _ in lb]
    for (path, x), (_, y) in zip(la, lb):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y), err_msg=jax.tree_util.keystr(path))


def test_jax_init_round_trips_through_the_port_exactly():
    ht = _tiny_htdemucs()
    _same_leaves(htdemucs.params_of(htdemucs.HTDemucs.from_params(ht), ht), ht)
    br = _init(jbr, 1, input_dim=12, hidden=8)
    br["feat_mean"], br["feat_std"] = np.arange(12, dtype=np.float32), np.ones(12, np.float32)
    _same_leaves(beat_rnn.params_of(beat_rnn_train.trainable(br, CPU), br), br)
    dcp = _init(jdc, 2, input_dim=30)
    _same_leaves(deepchroma.params_of(deepchroma.DeepChromaDNN.from_params(dcp), dcp), dcp)
    kcp = _init(jkc, 3)
    _same_leaves(key_cnn.params_of(key_cnn.KeyCNN.from_params(kcp), kcp), kcp)
    bpp = _init(jbp, 4)
    _same_leaves(basicpitch.params_of(basicpitch.BasicPitchCNN.from_params(bpp), bpp), bpp)


def test_port_init_has_the_jax_shapes_and_scales():
    g = torch.Generator().manual_seed(0)
    cases = [
        (htdemucs.init_params(g, n_sources=2, channels=8, bottom=64, t_layers=2), _tiny_htdemucs()),
        (beat_rnn.init_params(g, 300), _init(jbr, 0, input_dim=300)),
        (deepchroma.init_params(g, 1800), _init(jdc, 0, input_dim=1800)),
        (key_cnn.init_params(g), _init(jkc, 0)),
        (basicpitch.init_params(g), _init(jbp, 0)),
        (crf_chords.init_params(g), _init(jcc, 0)),
    ]
    for ours, ref in cases:
        for (path, r), o in zip(jax.tree_util.tree_flatten_with_path(ref)[0], jax.tree.leaves(ours)):
            name = jax.tree_util.keystr(path)
            assert o.shape == r.shape and o.dtype == np.float32, name
            if any(k in name for k in ("gamma", "scale", "freq_emb")):
                continue  # the htdemucs fixture redraws LayerScale; the embedding is checked below
            if r.size > 100 and float(np.std(r)) > 0:  # fan-in scaling: the two sample stds within 5 sigma
                assert abs(float(np.std(o)) / float(np.std(r)) - 1) < 5 / np.sqrt(r.size), name
            elif float(np.std(r)) == 0:
                np.testing.assert_array_equal(o, r, err_msg=name)  # constants: biases, norms, CRF prior
    ours = htdemucs.init_params(g, n_sources=2, channels=8, bottom=64, t_layers=2)
    np.testing.assert_allclose(ours["freq_emb"], _jax_tiny_htdemucs()["freq_emb"], rtol=1e-6)
    assert float(ours["tlayers"][0]["gamma1"][0]) == pytest.approx(1e-4) and float(ours["encoder"][0]["dconv"]["blocks"][0]["scale"][0]) == pytest.approx(1e-3)


def test_port_checkpoints_load_in_the_jax_package(tmp_path):
    rng = np.random.default_rng(11)
    # htdemucs: save_pytree_npz with meta_segment; the leaves load unchanged (the forward on
    # those leaves is held against the port's in tests/test_torch_htdemucs.py)
    ht = {**_tiny_htdemucs(), "meta_segment": np.asarray(8192, np.int64)}
    htdemucs.save_params(tmp_path / "htdemucs.npz", ht)
    loaded = jhd.load_params(str(tmp_path / "htdemucs.npz"))
    _same_leaves(loaded, ht)
    assert htdemucs.program_config(htdemucs.load_params(str(tmp_path / "htdemucs.npz")), "htdemucs_6s", ["guitar"])["seg"] == 8192

    # beat_rnn: the flattened two-member ensemble layout
    m0 = _init(jbr, 1, input_dim=beat_features_dim(), hidden=8)
    m1 = _init(jbr, 2, input_dim=beat_features_dim(), hidden=8)
    m1["full_context"] = np.float32(1.0)
    beat_rnn.save_params(str(tmp_path / "beat_rnn.npz"), {**m0, "ensemble": [m1]})
    jl = jbr.load_params(str(tmp_path / "beat_rnn.npz"))
    assert len(jl["ensemble"]) == 1 and "full_context" in jl["ensemble"][0]
    y = (0.3 * rng.standard_normal(22050 * 3)).astype(np.float32)
    ref = np.asarray(jbr.beat_activation(jnp.asarray(y), 22050, 100, params=jl))
    with torch.inference_mode():
        got = beat_rnn.beat_activation(torch.from_numpy(y), 22050, beat_rnn.ensemble_from_params(beat_rnn.load_params(str(tmp_path / "beat_rnn.npz"))))
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5)

    # deepchroma: the trainer's flat layout
    dcp = _init(jdc, 3, input_dim=1800)
    dcp["feat_mean"], dcp["feat_std"] = rng.uniform(size=1800).astype(np.float32), rng.uniform(1, 2, 1800).astype(np.float32)
    deepchroma.save_params(str(tmp_path / "deepchroma.npz"), dcp)
    jd = jdc.load_params(str(tmp_path / "deepchroma.npz"))
    feats = np.abs(rng.standard_normal((5, 1800))).astype(np.float32)
    with torch.inference_mode():
        got = deepchroma.DeepChromaDNN.from_params(deepchroma.load_params(str(tmp_path / "deepchroma.npz")))(torch.from_numpy(feats))
    np.testing.assert_allclose(got.numpy(), np.asarray(jdc.apply(jd, jnp.asarray(feats))), atol=1e-5)

    # key_cnn, basicpitch: np.savez of the flat pytree, as the JAX trainers write them
    kcp = _init(jkc, 4)
    np.savez(tmp_path / "key_cnn.npz", **kcp)
    jk = jkc.load_params(str(tmp_path / "key_cnn.npz"))
    kf = np.abs(rng.standard_normal((12, 120, 1))).astype(np.float32)
    with torch.inference_mode():
        got = key_cnn.KeyCNN.from_params(key_cnn.load_params(str(tmp_path / "key_cnn.npz")))(torch.from_numpy(kf))
    np.testing.assert_allclose(got.numpy(), np.asarray(jkc.apply(jk, jnp.asarray(kf))), atol=1e-6)
    bpp = _init(jbp, 5)
    np.savez(tmp_path / "basicpitch.npz", **bpp)
    _same_leaves(jbp.load_params(str(tmp_path / "basicpitch.npz")), basicpitch.load_params(str(tmp_path / "basicpitch.npz")))

    # crf: the plain npz of a trained candidate
    crf = {"emit_w": crf_chords_train.template_init(3) * 1.5, "emit_b": np.zeros(25, np.float32),
           "transitions": crf_chords_train._transitions_from_bigrams([rng.integers(0, 25, 50)]),
           "initial": np.full(25, -np.log(25), np.float32)}
    np.savez(tmp_path / "crf.npz", **crf)
    jc = jcc.load_params(str(tmp_path / "crf.npz"))
    ch = np.abs(rng.standard_normal((40, 12))).astype(np.float32)
    ref_path, ref_conf = jcc.decode(jc, jnp.asarray(ch))
    path, conf = crf_chords.decode(crf_chords.load_params(str(tmp_path / "crf.npz")), torch.from_numpy(ch))
    np.testing.assert_array_equal(path.numpy(), np.asarray(ref_path))
    np.testing.assert_allclose(conf.numpy(), np.asarray(ref_conf), rtol=1e-5)


def beat_features_dim() -> int:
    return int(beat_rnn.spectral_features(torch.zeros(22050), 22050).shape[-1])
