"""Train the CRF chord recognizer's emissions (models/crf_chords.py), on the card.

Counterpart of audiotabs_tpu/train/crf_chords_train.py: frame-wise
multinomial logistic regression over the production feature (the DeepChroma
net's chroma, per-frame L2-normalised and silence-gated, the HPSS medians on
the card), started from the analytic template weights on the centre frame
of a context window, Adam under a cosine-decayed rate (alpha 0.05),
transitions from smoothed bigram counts, a (tau, alpha) template blend
chosen on a selection split, and the same save gates against the template
emissions on held-out clips and the committed held-out corpus. No
checkpoint has passed them so far, in either package. The JAX trainer's
golden-WAV constraint on the (tau, alpha) pick, its golden gate and its
ratchet need a corpus the repo does not hold and are not ported
(train/golden.py); without it the JAX trainer takes the plain argmax too.
The checkpoint is the JAX trainer's plain npz.

Usage:
    python -m audiotabs_tpu_torch.train.crf_chords_train \
        [--clips 60] [--steps 2000] [--device cuda] [--out build/weights/crf_chords.npz]
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import numpy as np
import torch

from ..device import resolve_device
from ..models import crf_chords as cc
from ..models import deepchroma as dc
from . import heldout_wavs
from .optim import Trainer, device_arg, no_tf32

SR = 22050
CLIP_S = 12.0
FPS = 10


def _dnn_chroma(yh: torch.Tensor, dc_net: dc.DeepChromaDNN) -> np.ndarray:
    """[T, 12] production CRF features: the DNN chroma, per-frame
    L2-normalised, with near-silent frames zeroed (the fused analysis' gate)."""
    from ..ops.features import rms

    with torch.inference_mode(), no_tf32():
        ch = dc_net(dc.features(yh, SR)).cpu().numpy()
        energy = rms(yh, frame_length=2048, hop=SR // FPS).cpu().numpy()
    ch = ch / np.maximum(np.linalg.norm(ch, axis=1, keepdims=True), 1e-9)
    energy = energy / (energy.max() + 1e-9)
    n = min(len(energy), len(ch))
    ch[:n] *= (energy[:n] > 0.05).astype(np.float32)[:, None]
    return ch


def _state_labels(labels, n_frames: int) -> np.ndarray:
    """[(start, end, root_pc, quality)] → [T] state ids (0 = N)."""
    out = np.zeros(n_frames, dtype=np.int32)
    for start, end, root_pc, qual in labels:
        a = int(round(start * FPS))
        b = min(n_frames, max(a + 1, int(round(end * FPS))))
        out[a:b] = 1 + root_pc + (12 if qual == "min" else 0)
    return out


def _dc_net(dc_params: dict, device: torch.device) -> dc.DeepChromaDNN:
    return dc.DeepChromaDNN.from_params(dc_params).to(device).eval()


def build_dataset(n_clips: int, seed: int, dc_params, cache: bool = True, device=None):
    """→ per-clip features [T, 12] and state ids [T], numpy lists.

    Cached under $TMPDIR, keyed on the generator version, the DeepChroma
    checkpoint's identity and the draw, with a ``torch_`` prefix so that
    neither package reads the other's features."""
    import os
    import tempfile

    from ..ops.hpss import hpss
    from .synth import SYNTH_VERSION, synth_chord_clip

    dc_tag = "none"
    dc_path = dc.weights_path("DEEPCHROMA_WEIGHTS", "deepchroma.npz")
    if dc_path and os.path.exists(dc_path):
        st = os.stat(dc_path)
        dc_tag = f"{int(st.st_mtime)}_{st.st_size}"
    cache_path = os.path.join(tempfile.gettempdir(), f"torch_crf_ds_v{SYNTH_VERSION}_{dc_tag}_{n_clips}_{seed}.npz")
    if cache and os.path.exists(cache_path):
        data = np.load(cache_path)
        k = int(data["n"])
        return [data[f"x{i}"] for i in range(k)], [data[f"y{i}"] for i in range(k)]
    device = resolve_device(device)
    net = _dc_net(dc_params, device)
    rng = np.random.default_rng(seed)
    X, Y = [], []
    for _ in range(n_clips):
        y, labels = synth_chord_clip(rng, CLIP_S, SR)
        yh = hpss(torch.from_numpy(np.ascontiguousarray(y, np.float32)).to(device))[0]
        ch = _dnn_chroma(yh, net)
        X.append(ch)
        Y.append(_state_labels(labels, ch.shape[0]))
    if cache:
        np.savez(cache_path, n=len(X), **{f"x{i}": x for i, x in enumerate(X)}, **{f"y{i}": y for i, y in enumerate(Y)})
    return X, Y


def _transitions_from_bigrams(seqs, alpha: float = 1.0) -> np.ndarray:
    counts = np.full((cc.N_STATES, cc.N_STATES), alpha, dtype=np.float64)
    for s in seqs:
        np.add.at(counts, (s[:-1], s[1:]), 1.0)
    return np.log(counts / counts.sum(axis=1, keepdims=True)).astype(np.float32)


def _decode_accuracy(params, X_clips, Y_clips, device: torch.device) -> float:
    accs = []
    for ch, st in zip(X_clips, Y_clips):
        path, _ = cc.decode(params, torch.from_numpy(ch).to(device))
        mask = st > 0
        if mask.any():
            accs.append(float((path.cpu().numpy()[mask] == st[mask]).mean()))
    return float(np.mean(accs))


def _ctx_stack_np(ch: np.ndarray, width: int) -> np.ndarray:
    return cc.context_stack(torch.from_numpy(ch), width).numpy()


_HELDOUT_CACHE: dict = {}


def _heldout_overlap(params, device: torch.device) -> float | None:
    """Mean chord overlap against the exact ground truth of the committed
    held-out corpus (tests/data/heldout/), clips no trainer draws."""
    import json

    from ..chords.segments import frames_to_segments
    from ..io.resample import resample_poly_host
    from ..io.wav import load_wav, peak_normalize
    from ..ops.hpss import hpss

    wavs = heldout_wavs()
    if not wavs:
        return None
    pc_names = ["C", "C#", "D", "D#", "E", "F", "F#", "G", "G#", "A", "A#", "B"]
    net = _dc_net(dc.load_params(), device)
    scores = []
    for wav in wavs:
        gt = json.loads(wav.with_suffix(".json").read_text())
        ch = _HELDOUT_CACHE.get((wav.name, str(device)))
        if ch is None:
            y, sr = load_wav(wav)
            y = resample_poly_host(peak_normalize(y), sr, SR)
            ch = _dnn_chroma(hpss(torch.from_numpy(y).to(device))[0], net)
            _HELDOUT_CACHE[(wav.name, str(device))] = ch
        path, conf = cc.decode(params, torch.from_numpy(ch).to(device))
        times = np.arange(path.shape[0], dtype=np.float32) / FPS
        segs = frames_to_segments(path.cpu().numpy(), conf.cpu().numpy(), times, cc.LABELS, min_len=0.25)

        def our_label(t):
            return next((c.label for c in segs if c.start <= t < c.end), None)

        def gt_label(t):
            return next((f'{pc_names[c["root_pc"]]}:{c["quality"]}' for c in gt["chords"] if c["start"] <= t < c["end"]), None)

        ts = np.arange(gt["chords"][0]["start"], gt["chords"][-1]["end"], 0.05)
        scores.append(sum(1 for t in ts if our_label(t) == gt_label(t)) / len(ts))
    return float(np.mean(scores))


def template_init(ctx: int) -> np.ndarray:
    """The analytic template weights on the centre frame of a ``ctx``-frame window, zero on the others."""
    w = np.zeros((12 * ctx, cc.N_STATES), np.float32)
    w[12 * (ctx // 2) : 12 * (ctx // 2 + 1)] = np.asarray(cc.template_emission_params()["emit_w"])
    return w


def loss_fn(w: torch.Tensor, xb: torch.Tensor, yb: torch.Tensor) -> torch.Tensor:
    """The NLL of the true state under the log-softmax of the emissions (no bias)."""
    logp = torch.log_softmax(xb @ w, dim=-1)
    return -logp[torch.arange(xb.shape[0], device=xb.device), yb.long()].mean()


def update(w: torch.Tensor, trainer: Trainer, xb, yb) -> torch.Tensor:
    loss = loss_fn(w, xb, yb)
    loss.backward()
    trainer.step()
    return loss.detach()


def train(n_clips: int = 60, steps: int = 2000, batch: int = 512, seed: int = 0,
          out_path: str = "build/weights/crf_chords.npz", init: str = "template", trans: str = "bigram", ctx: int = 3,
          device: str | torch.device | None = None) -> dict:
    device = resolve_device(device)
    t0 = time.time()
    dc_params = dc.load_params()
    if dc_params is None:
        print("DeepChroma weights required (the CRF's production features)", flush=True)
        return {}
    X_clips, Y_clips = build_dataset(n_clips, seed, dc_params, device=device)
    X = np.concatenate([_ctx_stack_np(x, ctx) for x in X_clips])
    Y = np.concatenate(Y_clips)
    print(f"dataset: {X.shape} frames, ctx={ctx} ({time.time()-t0:.0f}s)", flush=True)

    # emit_b stays zero: gated all-zero feature rows must give uniform emissions
    w_tmpl = template_init(ctx)
    if init == "template":
        w0, lr = w_tmpl, 1e-2
    else:
        w0, lr = np.zeros((12 * ctx, cc.N_STATES), np.float32), 5e-2
    w = torch.nn.Parameter(torch.from_numpy(w0.copy()).to(device))
    trainer = Trainer([w], lr, steps, alpha=0.05)
    rng = np.random.default_rng(seed)
    with no_tf32():
        for step in range(steps):
            sel = rng.integers(0, X.shape[0], size=batch)
            loss = update(w, trainer, torch.from_numpy(X[sel]).to(device), torch.from_numpy(Y[sel]).to(device))
            if step % 500 == 0 or step == steps - 1:
                print(f"step {step}: loss {float(loss):.4f} ({time.time()-t0:.0f}s)", flush=True)
    w_np = w.detach().cpu().numpy()

    trans_m = _transitions_from_bigrams(Y_clips) if trans == "bigram" else np.asarray(cc.template_emission_params()["transitions"])

    def cand(tau: float, alpha: float) -> dict:
        # the template prior blended with the learned update, sharpened by tau
        return {
            "emit_w": ((alpha * w_tmpl + (1 - alpha) * w_np) * tau).astype(np.float32),
            "emit_b": np.zeros((cc.N_STATES,), np.float32),
            "transitions": trans_m,
            "initial": np.full((cc.N_STATES,), -np.log(cc.N_STATES), np.float32),
        }

    # (tau, alpha) on a selection split
    Xs, Ys = build_dataset(30, seed + 55_000, dc_params, device=device)
    grid = [(tau, alpha) for tau in (1.0, 1.5, 2.0, 3.0) for alpha in (0.0, 0.25, 0.5, 0.75, 0.85, 0.9)]
    accs = {ta: _decode_accuracy(cand(*ta), Xs, Ys, device) for ta in grid}
    print("selection sweep (tau, alpha):", {f"{t}/{a}": round(v, 4) for (t, a), v in accs.items()}, flush=True)
    tmpl = cc.template_emission_params()
    h_tmpl = _heldout_overlap(tmpl, device)
    tau_best, alpha_best = max(grid, key=lambda ta: accs[ta])
    trained = cand(tau_best, alpha_best)

    Xv, Yv = build_dataset(30, seed + 33_000, dc_params, device=device)
    acc_tr = _decode_accuracy(trained, Xv, Yv, device)
    acc_tmpl = _decode_accuracy(tmpl, Xv, Yv, device)
    print(f"val frame accuracy: trained(tau={tau_best}, alpha={alpha_best}) {acc_tr:.4f} vs template {acc_tmpl:.4f}", flush=True)

    heldout_ok = True
    h_tr = _heldout_overlap(trained, device)
    if h_tr is not None and h_tmpl is not None:
        print(f"heldout overlap: trained {h_tr:.3f} vs template {h_tmpl:.3f}", flush=True)
        heldout_ok = h_tr >= h_tmpl - 0.01

    report = {"acc_trained": acc_tr, "acc_template": acc_tmpl, "heldout_ok": heldout_ok}
    saved = accept(report)
    if saved:
        Path(out_path).parent.mkdir(parents=True, exist_ok=True)
        np.savez(out_path, **trained)
        print(f"saved {out_path}", flush=True)
    else:
        print("NOT saved: trained CRF fails an acceptance gate", flush=True)
    return {**report, "params": trained, "saved": saved}


def accept(report: dict) -> bool:
    """The save gate: held-out decode accuracy at least the template
    emissions', and within 0.01 of the templates on the held-out corpus."""
    return report["acc_trained"] >= report["acc_template"] and report["heldout_ok"]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--clips", type=int, default=60)
    ap.add_argument("--steps", type=int, default=2000)
    ap.add_argument("--batch", type=int, default=512)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="build/weights/crf_chords.npz")
    ap.add_argument("--init", choices=["template", "zero"], default="template")
    ap.add_argument("--trans", choices=["bigram", "prior"], default="bigram")
    ap.add_argument("--ctx", type=int, default=3, help="context window (frames) for the emission features")
    device_arg(ap)
    args = ap.parse_args(argv)
    train(args.clips, args.steps, args.batch, args.seed, args.out, init=args.init, trans=args.trans, ctx=args.ctx,
          device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
