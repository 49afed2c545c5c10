"""Train the beat BLSTM ensemble (models/beat_rnn.py) on synthetic clips, on the card.

Counterpart of audiotabs_tpu/train/beat_rnn_train.py: the same clips and
beat grids (train/synth.synth_beat_clip from the same numpy seeds), the
same features (the mix and its HPSS percussive part, the median kernel on
the card), 256-frame training windows, the weighted BCE with the
normalisation statistics' gradients zeroed, Adam under a cosine-decayed
rate (alpha 0.05), a snapshot per epoch selected on the validation DBN
F-measure, and the same save gate against the DSP spectral-flux baseline.
The JAX trainer's golden-oracle selection, pruning and ratchet need a
corpus the repo does not hold and are not ported (train/golden.py). The
checkpoint has the JAX ``save_params`` layout (members under
m1_/m2_/… prefixes), which both packages load.

Usage:
    python -m audiotabs_tpu_torch.train.beat_rnn_train \
        [--clips 48] [--epochs 24] [--ensemble 3] [--device cuda] \
        [--out build/weights/beat_rnn.npz]
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import numpy as np
import torch

from ..analysis.metrics import beat_f_measure as f_measure
from ..decode.dbn_beats import dbn_beat_track
from ..device import resolve_device
from ..models import beat_rnn
from .optim import Trainer, device_arg, no_tf32, norm_as_parameters, zero_norm_grads

FPS = 100
WINDOW = 256  # frames per training window (matches chunked inference)
MARGIN = 32


def build_dataset(n_clips: int, seed: int, sr: int = 22050, duration: float = 12.0, device=None):
    """→ (features [N, T, D], targets [N, T], clips [(y, beats)]), numpy.

    Cached under $TMPDIR keyed on the generator version and the draw; the
    file name carries a ``torch_`` prefix so that neither package reads the
    other's features."""
    import os
    import tempfile

    from ..ops.hpss import hpss
    from .synth import SYNTH_VERSION, synth_beat_clip

    cache_path = os.path.join(tempfile.gettempdir(), f"torch_beat_ds_v{SYNTH_VERSION}_{n_clips}_{seed}_{sr}_{duration}.npz")
    if os.path.exists(cache_path):
        d = np.load(cache_path)
        return d["X"], d["Y"], [(d[f"y{i}"], d[f"b{i}"]) for i in range(n_clips)]

    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    feats, targets, clips = [], [], []
    for _ in range(n_clips):
        y, beats = synth_beat_clip(rng, duration, sr)
        clips.append((y, beats))
        # the mix and its percussive part: the pipeline's fallback feeds the BLSTM the latter
        yd = torch.from_numpy(np.ascontiguousarray(y, np.float32)).to(device)
        yp = hpss(yd)[1].cpu()
        for sig in (yd, yp.to(device)):
            f = beat_rnn.spectral_features(sig, sr, FPS).cpu().numpy()
            t = np.zeros(f.shape[0], dtype=np.float32)
            idx = np.clip(np.round(beats * FPS).astype(int), 0, len(t) - 1)
            t[idx] = 1.0
            for off in (-1, 1):
                j = np.clip(idx + off, 0, len(t) - 1)
                t[j] = np.maximum(t[j], 0.5)
            feats.append(f)
            targets.append(t)
    T = min(f.shape[0] for f in feats)
    X = np.stack([f[:T] for f in feats])
    Y = np.stack([t[:T] for t in targets])
    try:
        np.savez(cache_path, X=X, Y=Y, **{f"y{i}": clips[i][0] for i in range(n_clips)},
                 **{f"b{i}": clips[i][1] for i in range(n_clips)})
    except OSError:
        pass
    return X, Y, clips


def windows(X: np.ndarray, Y: np.ndarray, hop: int = 128):
    """Slice [N, T, D]/[N, T] into training windows [M, WINDOW, ·]."""
    xs, ys = [], []
    for i in range(X.shape[0]):
        for a in range(0, X.shape[1] - WINDOW + 1, hop):
            xs.append(X[i, a : a + WINDOW])
            ys.append(Y[i, a : a + WINDOW])
    return np.stack(xs), np.stack(ys)


def loss_fn(net: beat_rnn.BeatBLSTM, xb: torch.Tensor, yb: torch.Tensor, pos_weight: float) -> torch.Tensor:
    """Windows [B, W, D] and targets [B, W] → the positive-weighted BCE of the activation."""
    act = torch.clamp(net(xb), 1e-6, 1 - 1e-6)
    return (-(pos_weight * yb * torch.log(act) + (1 - yb) * torch.log(1 - act))).mean()


def trainable(params: dict, device: torch.device) -> beat_rnn.BeatBLSTM:
    """A fresh module of one member's pytree, trainable as the JAX member:
    ``bias_hh`` frozen at zero (the JAX cell has one bias), the normalisation
    statistics parameters whose gradients the update zeroes."""
    net = beat_rnn.BeatBLSTM.from_params(params).to(device)
    norm_as_parameters(net)
    for name, p in net.lstm.named_parameters():
        p.requires_grad_(not name.startswith("bias_hh"))
    return net


def update(net, trainer: Trainer, xb: torch.Tensor, yb: torch.Tensor, pos_weight: float) -> torch.Tensor:
    loss = loss_fn(net, xb, yb, pos_weight)
    loss.backward()
    zero_norm_grads(net)  # the normalisation constants are data, not trainable
    trainer.step()
    return loss.detach()


def _act_for(p: dict, device: torch.device):
    """The production activation of a params pytree (members averaged)."""
    members = [m.to(device) for m in beat_rnn.ensemble_from_params(p)]

    def act(y: torch.Tensor) -> torch.Tensor:
        with torch.inference_mode():
            return beat_rnn.beat_activation(y, 22050, members, FPS)

    return act


def _onset_act(y: torch.Tensor) -> torch.Tensor:
    with torch.inference_mode():
        return beat_rnn.onset_activation(y, 22050, FPS)


def _train_member(member_seed, n_clips, epochs, batch, hidden, eval_f, t0, device,
                  pos_weight: float = 18.0, full_context: bool = False) -> dict:
    """Train one BLSTM on its own dataset draw and return its selected
    snapshot (a pytree): the best validation F over epochs."""
    X, Y, _ = build_dataset(n_clips, member_seed, device=device)
    mean = X.reshape(-1, X.shape[-1]).mean(axis=0)
    std = X.reshape(-1, X.shape[-1]).std(axis=0) + 1e-3
    if full_context:
        Xw, Yw = X, Y  # whole clips; the batch dimension is the clip
        batch = min(batch, 8)
    else:
        Xw, Yw = windows(X, Y)
    print(f"  member seed {member_seed}: windows {Xw.shape} ({time.time()-t0:.0f}s)", flush=True)

    template = beat_rnn.init_params(torch.Generator().manual_seed(member_seed), input_dim=X.shape[-1], hidden=hidden)
    template["feat_mean"], template["feat_std"] = mean.astype(np.float32), std.astype(np.float32)
    net = trainable(template, device)
    steps_per_epoch = max(1, Xw.shape[0] // batch)
    trainer = Trainer([p for p in net.parameters() if p.requires_grad], 2e-3, epochs * steps_per_epoch, alpha=0.05)

    np_rng = np.random.default_rng(member_seed)
    snapshots = []  # (epoch, val_f, params)
    for epoch in range(epochs):
        order = np_rng.permutation(Xw.shape[0])
        ep_loss = []
        with no_tf32():
            for b in range(steps_per_epoch):
                sel = order[b * batch : (b + 1) * batch]
                if len(sel) < batch:  # one batch shape, as the JAX trainer keeps one compiled shape
                    sel = np.concatenate([sel, order[: batch - len(sel)]])
                ep_loss.append(update(net, trainer, torch.from_numpy(Xw[sel]).to(device),
                                      torch.from_numpy(Yw[sel]).to(device), pos_weight))
        line = f"  epoch {epoch}: loss {float(torch.stack(ep_loss).sum()) / steps_per_epoch:.4f}"
        snap = beat_rnn.params_of(net, template)
        if full_context:
            snap["full_context"] = np.float32(1.0)
        vf = eval_f(_act_for(snap, device))
        snapshots.append((epoch, vf, snap))
        print(line + f"  val F {vf:.3f} ({time.time()-t0:.0f}s)", flush=True)

    viable = [s for s in snapshots if s[1] >= 0.85] or snapshots
    epoch_b, vf, best = max(viable, key=lambda s: s[1])
    print(f"  selected epoch {epoch_b}: val F {vf:.3f}", flush=True)
    return best


def train(n_clips: int = 48, epochs: int = 24, batch: int = 32, seed: int = 0, out_path: str = "build/weights/beat_rnn.npz",
          hidden: int = 25, ensemble: int = 3, include_existing: bool = False, full_context: bool = False,
          device: str | torch.device | None = None) -> dict:
    device = resolve_device(device)
    t0 = time.time()
    Xv, _Yv, val_clips = build_dataset(8, seed + 10_000, device=device)
    print(f"val dataset: {Xv.shape} ({time.time()-t0:.0f}s)", flush=True)

    def eval_f(act_fn) -> float:
        return float(np.mean([f_measure(dbn_beat_track(act_fn(torch.from_numpy(y).to(device))), beats)
                              for y, beats in val_clips]))

    members = []
    if include_existing and Path(out_path).exists():
        existing = beat_rnn.load_params(str(out_path))
        if existing is not None:
            flat = [{k: v for k, v in existing.items() if k != "ensemble"}] + list(existing.get("ensemble", []))
            members.extend(flat)
            print(f"seeded with {len(flat)} existing member(s)", flush=True)

    n_new = max(1, ensemble) if not members else max(0, ensemble - len(members))
    total = len(members) + n_new
    for j in range(n_new):
        pw = (9.0, 30.0, 13.0, 18.0)[j % 4]  # the positive-class weight of each member
        print(f"member {len(members) + 1}/{total} (pos_weight {pw}):", flush=True)
        members.append(_train_member(seed + 101 * j, n_clips, epochs, batch, hidden, eval_f, t0, device,
                                     pos_weight=pw, full_context=full_context))

    combined = dict(members[0])
    if len(members) > 1:
        combined["ensemble"] = members[1:]
    f_ens = eval_f(_act_for(combined, device))
    f_dsp = eval_f(_onset_act)
    print(f"ENSEMBLE ({len(members)}): val F {f_ens:.3f} (DSP {f_dsp:.3f})", flush=True)
    report = {"f_ens": f_ens, "f_dsp": f_dsp}
    saved = accept(report)
    if saved:
        Path(out_path).parent.mkdir(parents=True, exist_ok=True)
        beat_rnn.save_params(out_path, combined)
        print(f"saved {out_path} ({len(members)} members)", flush=True)
    else:
        print("NOT saved: candidate does not beat the DSP baseline on the gates", flush=True)
    return {**report, "params": combined, "saved": saved}


def accept(report: dict) -> bool:
    """The save gate: the ensemble's validation F at least the DSP baseline's
    (capped at 0.95) and above 0.85."""
    return report["f_ens"] >= min(report["f_dsp"], 0.95) and report["f_ens"] > 0.85


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--clips", type=int, default=48)
    ap.add_argument("--epochs", type=int, default=24)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--hidden", type=int, default=25)
    ap.add_argument("--ensemble", type=int, default=3)
    ap.add_argument("--include-existing", action="store_true", help="seed the ensemble with the checkpoint at --out")
    ap.add_argument("--context", choices=("windowed", "full"), default="windowed",
                    help="full = train and serve new members on whole sequences (madmom RNNBeatProcessor semantics)")
    ap.add_argument("--out", default="build/weights/beat_rnn.npz")
    device_arg(ap)
    args = ap.parse_args(argv)
    res = train(args.clips, args.epochs, args.batch, args.seed, args.out, args.hidden, args.ensemble,
                include_existing=args.include_existing, full_context=(args.context == "full"), device=args.device)
    return 0 if res["f_ens"] > 0 else 1


if __name__ == "__main__":
    sys.exit(main())
