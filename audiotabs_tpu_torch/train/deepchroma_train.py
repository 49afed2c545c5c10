"""Train the deep-chroma DNN (models/deepchroma.py) on synthetic chords, on the card.

Counterpart of audiotabs_tpu/train/deepchroma_train.py: the same clips
(train/synth.synth_chord_clip from the same numpy seeds) in the
HPSS-harmonic domain (the median kernel on the card), chord-tone targets,
transposition augmentation with gain and noise jitter from the same numpy
generator, dropout 0.3 after each ReLU layer, the positive-weighted BCE,
AdamW (weight decay 1e-4, which also shrinks the normalisation statistics:
they stay in the optimizer with zeroed gradients, as in optax) under a
cosine-decayed rate (alpha 0.05), and the same save gate: CRF-decoded
chord accuracy above the salience chroma's. The JAX trainer's golden-WAV
gate (progression and overlap) needs a corpus the repo does not hold and is
not ported (train/golden.py). The checkpoint is the JAX trainer's flat npz.

The dropout masks come from a ``torch.Generator``, so they differ from the
JAX run's ``jax.random`` masks; ``loss_fn`` takes explicit masks, which the
parity tests share between the packages.

Usage:
    python -m audiotabs_tpu_torch.train.deepchroma_train \
        [--clips 60] [--steps 3000] [--device cuda] [--out build/weights/deepchroma.npz]
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from ..device import resolve_device
from ..models import deepchroma as dc
from ..theory.vocabulary import QUALITY_INTERVALS
from .optim import Trainer, device_arg, no_tf32, norm_as_parameters, zero_norm_grads

SR = 22050
CLIP_S = 12.0
KEEP = 0.7  # dropout 0.3


def chroma_targets(labels, n_frames: int) -> np.ndarray:
    """[(start, end, root_pc, quality)] → [T, 12] chord-tone indicator."""
    out = np.zeros((n_frames, 12), dtype=np.float32)
    for start, end, root_pc, qual in labels:
        a = int(round(start * dc.FPS))
        b = min(n_frames, max(a + 1, int(round(end * dc.FPS))))
        for iv in QUALITY_INTERVALS[qual]:
            out[a:b, (root_pc + iv) % 12] = 1.0
    return out


def build_dataset(n_clips: int, seed: int, device=None):
    """→ (features [N·T, D], targets [N·T, 12], clips [(harmonic, labels)], T), numpy."""
    from ..ops.hpss import hpss
    from .synth import synth_chord_clip

    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    feats, targets, clips = [], [], []
    for _ in range(n_clips):
        y, labels = synth_chord_clip(rng, CLIP_S, SR)
        yh = hpss(torch.from_numpy(np.ascontiguousarray(y, np.float32)).to(device))[0]
        f = dc.features(yh, SR).cpu().numpy()
        feats.append(f)
        targets.append(chroma_targets(labels, f.shape[0]))
        clips.append((yh.cpu().numpy(), labels))
    T = min(f.shape[0] for f in feats)
    return np.concatenate([f[:T] for f in feats]), np.concatenate([t[:T] for t in targets]), clips, T


def augment_batch(X: np.ndarray, Y: np.ndarray, rng: np.random.Generator):
    """Random per-sample transposition (quarter-tone band shift with zero
    fill of every context frame; the chroma target rolls by k) + gain/noise jitter."""
    B = X.shape[0]
    nb = dc.N_BANDS
    ctx = X.shape[1] // nb
    ks = rng.integers(-5, 7, size=B)
    Xs = X.reshape(B, ctx, nb)
    Xa = np.zeros_like(Xs)
    for i, k in enumerate(ks):
        b = 2 * abs(int(k))
        if k > 0:
            Xa[i, :, b:] = Xs[i, :, : nb - b]
        elif k < 0:
            Xa[i, :, : nb - b] = Xs[i, :, b:]
        else:
            Xa[i] = Xs[i]
    Xa = Xa.reshape(B, -1)
    gains = rng.uniform(0.6, 1.4, size=(B, 1)).astype(np.float32)
    Xa = Xa * gains + rng.normal(0.0, 0.05, size=Xa.shape).astype(np.float32)
    Ya = np.stack([np.roll(Y[i], int(k)) for i, k in enumerate(ks)])
    return Xa.astype(np.float32), Ya.astype(np.float32)


def dropout_masks(net: dc.DeepChromaDNN, batch: int, generator: torch.Generator) -> list[torch.Tensor]:
    """One keep mask (probability 0.7) per hidden layer, drawn on the generator's device."""
    return [(torch.rand((batch, layer.out_features), generator=generator, device=generator.device) < KEEP).float()
            for layer in net.layers]


def loss_fn(net: dc.DeepChromaDNN, xb: torch.Tensor, yb: torch.Tensor, keep: list[torch.Tensor]) -> torch.Tensor:
    """The positive-weighted (2.0) BCE of the chroma, with inverted dropout by ``keep``."""
    x = (xb - net.feat_mean) / net.feat_std
    for layer, mask in zip(net.layers, keep):
        x = F.relu(layer(x)) * mask / KEEP
    pred = torch.clamp(torch.sigmoid(net.out(x)), 1e-6, 1 - 1e-6)
    return (-(2.0 * yb * torch.log(pred) + (1 - yb) * torch.log(1 - pred))).mean()


def trainable(params: dict, device: torch.device) -> dc.DeepChromaDNN:
    net = dc.DeepChromaDNN.from_params(params).to(device)
    norm_as_parameters(net)
    return net


def update(net, trainer: Trainer, xb, yb, keep) -> torch.Tensor:
    loss = loss_fn(net, xb, yb, keep)
    loss.backward()
    zero_norm_grads(net)
    trainer.step()
    return loss.detach()


def _chord_accuracy(chroma_12xT: np.ndarray, labels, n_frames: int, device: torch.device) -> float:
    """CRF-decode the chroma (on ``device``) and score frame-wise majmin accuracy."""
    from ..models import crf_chords

    chroma = chroma_12xT / (np.linalg.norm(chroma_12xT, axis=0, keepdims=True) + 1e-9)
    feats = torch.from_numpy(np.ascontiguousarray(chroma.T)).to(device)
    path = crf_chords.decode(crf_chords.template_emission_params(), feats)[0].cpu().numpy()
    truth = np.zeros(n_frames, dtype=int)
    for start, end, root_pc, qual in labels:
        a = int(round(start * dc.FPS))
        b = min(n_frames, max(a + 1, int(round(end * dc.FPS))))
        truth[a:b] = 1 + root_pc + (12 if qual == "min" else 0)
    n = min(len(path), n_frames)
    mask = truth[:n] > 0
    if not mask.any():
        return 0.0
    return float((path[:n][mask] == truth[:n][mask]).mean())


def _salience_chroma_of(yh: np.ndarray, n_frames: int, device: torch.device) -> np.ndarray:
    from ..chords.extract import salience_chroma
    from ..models.basicpitch import salience_posteriors

    with torch.inference_mode():
        _on, frame_post = salience_posteriors(torch.from_numpy(yh).to(device), SR)
        return salience_chroma(frame_post, n_frames).cpu().numpy()


def train(n_clips: int = 60, steps: int = 3000, batch: int = 256, seed: int = 0,
          out_path: str = "build/weights/deepchroma.npz", device: str | torch.device | None = None) -> dict:
    device = resolve_device(device)
    t0 = time.time()
    X, Y, _, _T = build_dataset(n_clips, seed, device)
    _Xv, _Yv, val_clips, _Tv = build_dataset(10, seed + 51_000, device)
    print(f"dataset: {X.shape} frames ({time.time()-t0:.0f}s)", flush=True)

    template = dc.init_params(torch.Generator().manual_seed(seed), input_dim=X.shape[1])
    template["feat_mean"] = X.mean(axis=0)
    template["feat_std"] = X.std(axis=0) + 1e-3
    net = trainable(template, device)
    trainer = Trainer(net.parameters(), 1e-3, steps, alpha=0.05, weight_decay=1e-4)
    gen = torch.Generator(device=device).manual_seed(seed)
    rng = np.random.default_rng(seed)
    with no_tf32():
        for step in range(steps):
            sel = rng.integers(0, X.shape[0], size=batch)
            xb, yb = augment_batch(X[sel], Y[sel], rng)
            loss = update(net, trainer, torch.from_numpy(xb).to(device), torch.from_numpy(yb).to(device),
                          dropout_masks(net, batch, gen))
            if step % 500 == 0 or step == steps - 1:
                print(f"step {step}: loss {float(loss):.4f} ({time.time()-t0:.0f}s)", flush=True)
    params = dc.params_of(net, template)
    net.eval()

    def dnn_chroma(yh: np.ndarray, n_frames: int) -> np.ndarray:
        with torch.inference_mode(), no_tf32():
            return net(dc.features(torch.from_numpy(yh).to(device), SR)[:n_frames]).T.cpu().numpy()

    acc_dnn, acc_sal = [], []
    for yh, labels in val_clips:
        n_frames = len(yh) // (SR // dc.FPS) + 1
        acc_dnn.append(_chord_accuracy(dnn_chroma(yh, n_frames), labels, n_frames, device))
        acc_sal.append(_chord_accuracy(_salience_chroma_of(yh, n_frames, device), labels, n_frames, device))
    a_dnn, a_sal = float(np.mean(acc_dnn)), float(np.mean(acc_sal))
    print(f"val chord accuracy: DNN {a_dnn:.3f} vs salience {a_sal:.3f}", flush=True)

    report = {"acc_dnn": a_dnn, "acc_sal": a_sal}
    saved = accept(report)
    if saved:
        Path(out_path).parent.mkdir(parents=True, exist_ok=True)
        dc.save_params(out_path, params)
        print(f"saved {out_path}", flush=True)
    else:
        print("NOT saved: DNN fails an acceptance gate", flush=True)
    return {**report, "params": params, "saved": saved}


def accept(report: dict) -> bool:
    """The save gate: CRF-decoded chord accuracy above the salience chroma's."""
    return report["acc_dnn"] > report["acc_sal"]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--clips", type=int, default=60)
    ap.add_argument("--steps", type=int, default=3000)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="build/weights/deepchroma.npz")
    device_arg(ap)
    args = ap.parse_args(argv)
    train(args.clips, args.steps, args.batch, args.seed, args.out, device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
