"""Carry the JAX package's parameter pytrees (numpy arrays) onto the port's modules.

Every model's weights pass through here, both from the npz checkpoints and
from the JAX package's ``init_params`` pytrees in the tests. Layouts:

  BLSTM     JAX per direction {W [D, 4H], U [H, 4H], b [4H]}, x @ W + h @ U + b,
            gates [i, f, g, o] (audiotabs_tpu/models/torch_port.py:36-54);
            torch nn.LSTM weight_ih [4H, D] = W.T, weight_hh [4H, H] = U.T,
            bias_ih = b, bias_hh = 0, gates in the same [i, f, g, o] order.
  conv2d    JAX HWIO [kh, kw, C_in, C_out] → torch OIHW [C_out, C_in, kh, kw].
  dense     JAX [D_in, D_out] → torch nn.Linear weight [D_out, D_in].
  htdemucs  conv and transposed-conv weights, the channel up/down projections
            ({up,down}_{s,t}_w, [out, in]) and norms are already in torch
            layout; the attention and feed-forward weights (q/k/v/o_w,
            lin1/2_w) are stored for x @ W and are transposed; ``freq_emb``
            already holds the embedding times its scale of 10.

``to_pytree`` runs any of these maps backwards: a module's state (or its
gradients) back to the JAX pytree, so the port's trainers write the JAX
package's checkpoint layout.
"""

from __future__ import annotations

import numpy as np
import torch

from ..tracing import uploaded


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def conv2d_hwio(w) -> torch.Tensor:
    return _t(np.transpose(np.asarray(w), (3, 2, 0, 1)))


def dense(prefix: str, w, b) -> dict[str, torch.Tensor]:
    return {f"{prefix}.weight": _t(np.asarray(w).T), f"{prefix}.bias": _t(b)}


def lstm_state(layers: list[dict], prefix: str = "lstm") -> dict[str, torch.Tensor]:
    """JAX BLSTM layers [{fwd: {W, U, b}, bwd: {...}}, ...] → nn.LSTM state dict."""
    out = {}
    for i, layer in enumerate(layers):
        for direction, suffix in (("fwd", ""), ("bwd", "_reverse")):
            p = layer[direction]
            out[f"{prefix}.weight_ih_l{i}{suffix}"] = _t(np.asarray(p["W"]).T)
            out[f"{prefix}.weight_hh_l{i}{suffix}"] = _t(np.asarray(p["U"]).T)
            out[f"{prefix}.bias_ih_l{i}{suffix}"] = _t(p["b"])
            out[f"{prefix}.bias_hh_l{i}{suffix}"] = torch.zeros(np.asarray(p["b"]).shape[0])
    return out


def _norm_state(params: dict) -> dict[str, torch.Tensor]:
    return {k: _t(params[k]) for k in ("feat_mean", "feat_std") if k in params}


def beat_blstm_state(params: dict) -> dict[str, torch.Tensor]:
    """beat_rnn pytree (one ensemble member) → BeatBLSTM state dict."""
    return {**lstm_state(params["layers"]), **dense("out", params["out_w"], params["out_b"]), **_norm_state(params)}


def conv_state(params: dict, names: tuple[str, ...]) -> dict[str, torch.Tensor]:
    """{<name>_w (HWIO), <name>_b} pytree entries → <name>.weight/.bias of Conv2d modules."""
    out = {}
    for n in names:
        out[f"{n}.weight"] = conv2d_hwio(params[f"{n}_w"])
        out[f"{n}.bias"] = _t(params[f"{n}_b"])
    return out


def deepchroma_state(params: dict) -> dict[str, torch.Tensor]:
    out = {}
    for i, layer in enumerate(params["layers"]):
        out.update(dense(f"layers.{i}", layer["w"], layer["b"]))
    out.update(dense("out", params["out_w"], params["out_b"]))
    out.update(_norm_state(params))
    return out


def key_cnn_state(params: dict) -> dict[str, torch.Tensor]:
    return {**conv_state(params, ("c1", "c2", "c3")), **dense("out", params["out_w"], params["out_b"])}


def _torch_layout(prefix: str, p: dict, names: tuple[str, ...]) -> dict[str, torch.Tensor]:
    """{<name>_w or <name>_g, <name>_b} entries, already in torch layout → <prefix>.<name>.weight/.bias."""
    out = {}
    for n in names:
        out[f"{prefix}.{n}.weight"] = _t(p[f"{n}_w"] if f"{n}_w" in p else p[f"{n}_g"])
        out[f"{prefix}.{n}.bias"] = _t(p[f"{n}_b"])
    return out


def htdemucs_state(params: dict) -> dict[str, torch.Tensor]:
    """htdemucs pytree (models/htdemucs.py of the JAX package) → HTDemucs state dict."""
    out = {"freq_emb": _t(params["freq_emb"])}
    for branch in ("encoder", "tencoder"):
        for i, layer in enumerate(params[branch]):
            out.update(_torch_layout(f"{branch}.{i}", layer, ("conv", "rewrite")))
            for j, blk in enumerate(layer["dconv"]["blocks"]):
                pre = f"{branch}.{i}.dconv.layers.{j}"
                out.update(_torch_layout(pre, blk, ("conv1", "gn1", "conv2", "gn2")))
                out[f"{pre}.scale"] = _t(blk["scale"])
    for branch in ("decoder", "tdecoder"):
        for i, layer in enumerate(params[branch]):
            out.update(_torch_layout(f"{branch}.{i}", layer, ("rewrite", "convtr")))
    out.update(_torch_layout("", params, ("up_s", "up_t", "down_s", "down_t", "norm_in", "norm_in_t")))
    for branch in ("tlayers", "tlayers_t"):
        for i, layer in enumerate(params[branch]):
            pre = f"{branch}.{i}"
            for n in ("q", "k", "v", "o", "lin1", "lin2"):
                out.update(dense(f"{pre}.{n}", layer[f"{n}_w"], layer[f"{n}_b"]))
            norms = ("norm1", "norm2", "norm3", "normout") if "norm3_g" in layer else ("norm1", "norm2", "normout")
            out.update(_torch_layout(pre, layer, norms))
            out[f"{pre}.gamma1"], out[f"{pre}.gamma2"] = _t(layer["gamma1"]), _t(layer["gamma2"])
    return {k.removeprefix("."): v for k, v in out.items()}


def crf_tensors(params: dict, device: torch.device) -> dict[str, torch.Tensor]:
    """CRF emission/transition arrays → float32 tensors on ``device``."""
    return {k: uploaded(_t(params[k]).to(device)) for k in ("emit_w", "emit_b", "transitions", "initial")}


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [leaf for k in tree for leaf in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in _leaves(v)]
    return [tree]


def _rebuild(tree, leaves):
    """``tree``'s structure with its leaves taken in order from the iterator ``leaves``."""
    if isinstance(tree, dict):
        return {k: _rebuild(v, leaves) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_rebuild(v, leaves) for v in tree]
    return next(leaves)


def to_pytree(state_fn, template, state: dict[str, torch.Tensor]) -> dict:
    """The inverse of ``state_fn`` (one of the ``*_state`` maps above): the
    tensors of ``state`` (keys of ``state_fn``'s output) back to ``template``'s
    pytree layout, as float32 numpy.

    Every state entry is a leaf, transposed or not, so ``state_fn`` is run once
    on a pytree whose entries are their own flat index (1-based, exact in
    float32 below 2**24 entries); each state entry then says where its values
    go. An entry ``state_fn`` fills with constants (the BLSTM's zero
    ``bias_hh``) carries index 0 and is dropped. A leaf that ``state_fn`` does
    not read (``meta_segment``, ``full_context``) keeps the template's value."""
    leaves = [np.asarray(leaf) for leaf in _leaves(template)]
    offs = np.cumsum([0] + [leaf.size for leaf in leaves])
    if offs[-1] >= 2**24:
        raise ValueError(f"{offs[-1]} entries do not index exactly in float32")
    tagged = [np.arange(o + 1, o + 1 + leaf.size, dtype=np.float64).reshape(leaf.shape) for o, leaf in zip(offs, leaves)]
    flat = np.zeros(offs[-1] + 1, np.float32)
    seen = np.zeros(offs[-1] + 1, bool)
    for key, idx in state_fn(_rebuild(template, iter(tagged))).items():
        ix = idx.numpy().astype(np.int64).ravel()
        keep = ix > 0
        flat[ix[keep]] = state[key].detach().float().cpu().numpy().ravel()[keep]
        seen[ix[keep]] = True
    out = []
    for o, leaf in zip(offs, leaves):
        hit = seen[o + 1 : o + 1 + leaf.size]
        if hit.all():
            out.append(flat[o + 1 : o + 1 + leaf.size].reshape(leaf.shape))
        elif not hit.any():
            out.append(leaf)
        else:
            raise ValueError(f"a leaf of shape {leaf.shape} is only partly in the module's state")
    return _rebuild(template, iter(out))

