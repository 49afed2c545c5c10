"""Train the key-classification CNN (models/key_cnn.py) on synthetic keys, on the card.

Counterpart of audiotabs_tpu/train/key_cnn_train.py: the same clips
(train/synth.synth_key_clip from the same numpy seeds) in the HPSS-harmonic
domain (the median kernel on the card), transposition augmentation by band
shifts with gain and noise jitter from the same numpy generator, the
label-smoothed NLL, AdamW (weight decay 1e-4) under a cosine-decayed rate
(alpha 0.05), and the same save gates: held-out accuracy above the
Krumhansl-profile estimator and the held-out corpus ratchet. The JAX
trainer's golden-WAV gate (G major) needs a corpus the repo does not hold and
is not ported (train/golden.py). The checkpoint is the JAX trainer's flat npz.

Usage:
    python -m audiotabs_tpu_torch.train.key_cnn_train \
        [--clips 128] [--steps 4000] [--device cuda] [--out build/weights/key_cnn.npz]
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import numpy as np
import torch

from ..device import resolve_device
from ..models import key_cnn as kc
from . import heldout_wavs
from .optim import Trainer, device_arg, no_tf32

SR = 22050
CLIP_S = 12.0


def _harmonic(y: np.ndarray, device: torch.device) -> torch.Tensor:
    from ..ops.hpss import hpss

    return hpss(torch.from_numpy(np.ascontiguousarray(y, np.float32)).to(device))[0]


def build_clips(n: int, seed: int, device=None):
    """→ (features [n, T, B, 1], labels [n] (pc, +12 for minor), harmonic audio), numpy."""
    from .synth import synth_key_clip

    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    feats, labels, audio = [], [], []
    for _ in range(n):
        y, pc, mode = synth_key_clip(rng, CLIP_S, SR)
        # the pipeline feeds the key CNN the HPSS-harmonic component
        yh = _harmonic(y, device)
        feats.append(kc.features(yh, SR).cpu().numpy())
        labels.append(pc + (0 if mode == "major" else 12))
        audio.append(yh.cpu().numpy())
    T = min(f.shape[0] for f in feats)
    return np.stack([f[:T] for f in feats]), np.asarray(labels, np.int32), audio


def transpose_feats(f: np.ndarray, k: int) -> np.ndarray:
    """Shift [T, B, 1] quarter-tone-banded features by k semitones (2k bins),
    zero-filling the vacated edge (no wraparound across the register)."""
    if k == 0:
        return f
    b = 2 * abs(k)
    out = np.zeros_like(f)
    if k > 0:
        out[:, b:, :] = f[:, :-b, :]
    else:
        out[:, :-b, :] = f[:, b:, :]
    return out


def augment_batch(X: np.ndarray, Y: np.ndarray, rng: np.random.Generator):
    """Random per-sample transposition in [-5, +6] semitones, gain and noise jitter."""
    ks = rng.integers(-5, 7, size=X.shape[0])
    Xa = np.stack([transpose_feats(x, int(k)) for x, k in zip(X, ks)])
    gains = rng.uniform(0.6, 1.4, size=(X.shape[0], 1, 1, 1)).astype(np.float32)
    Xa = Xa * gains + rng.normal(0.0, 0.05, size=Xa.shape).astype(np.float32)
    Ya = ((Y % 12) + ks) % 12 + (Y // 12) * 12
    return Xa.astype(np.float32), Ya.astype(np.int32)


def loss_fn(net: kc.KeyCNN, xb: torch.Tensor, yb: torch.Tensor) -> torch.Tensor:
    """Label-smoothed (0.1) NLL of the 24-key probabilities."""
    logp = torch.log(torch.clamp(net(xb), 1e-6, 1.0))
    nll = -logp[torch.arange(xb.shape[0], device=xb.device), yb.long()]
    return (0.9 * nll - 0.1 * logp.mean(dim=1)).mean()


def update(net, trainer: Trainer, xb: torch.Tensor, yb: torch.Tensor) -> torch.Tensor:
    loss = loss_fn(net, xb, yb)
    loss.backward()
    trainer.step()
    return loss.detach()


def _krumhansl_label(y: np.ndarray, device: torch.device) -> int | None:
    from ..chords.extract import chroma_features
    from ..theory.key import estimate_key_from_chroma

    chroma, _ = chroma_features(torch.from_numpy(y).to(device), SR)
    est = estimate_key_from_chroma(chroma.cpu().numpy())
    if est is None:
        return None
    return est.tonic_pc + (0 if est.mode == "major" else 12)


def _probs(params: dict, yh: torch.Tensor) -> np.ndarray:
    net = kc.KeyCNN.from_params(params).to(yh.device).eval()
    with torch.inference_mode():
        return net(kc.features(yh, SR)).cpu().numpy()


def train(n_clips: int = 128, steps: int = 4000, batch: int = 32, seed: int = 0,
          out_path: str = "build/weights/key_cnn.npz", device: str | torch.device | None = None) -> dict:
    device = resolve_device(device)
    t0 = time.time()
    X, Y, _ = build_clips(n_clips, seed, device)
    Xv, Yv, val_audio = build_clips(24, seed + 91_000, device)
    print(f"dataset: {X.shape} ({time.time()-t0:.0f}s)", flush=True)

    template = kc.init_params(torch.Generator().manual_seed(seed), n_bands=X.shape[2])
    net = kc.KeyCNN.from_params(template).to(device)
    trainer = Trainer(net.parameters(), 2e-3, steps, alpha=0.05, weight_decay=1e-4)
    rng = np.random.default_rng(seed)
    with no_tf32():
        for step in range(steps):
            sel = rng.choice(n_clips, size=batch, replace=False)
            xb, yb = augment_batch(X[sel], Y[sel], rng)
            loss = update(net, trainer, torch.from_numpy(xb).to(device), torch.from_numpy(yb).to(device))
            if step % 200 == 0 or step == steps - 1:
                print(f"step {step}: loss {float(loss):.4f} ({time.time()-t0:.0f}s)", flush=True)
        with torch.inference_mode():
            pred = net.eval()(torch.from_numpy(Xv).to(device)).argmax(dim=1).cpu().numpy()
    params = kc.params_of(net, template)
    acc_cnn = float((pred == Yv).mean())
    kr = [_krumhansl_label(y, device) for y in val_audio]
    acc_kr = float(np.mean([k == t for k, t in zip(kr, Yv) if k is not None]))
    print(f"val key accuracy: CNN {acc_cnn:.3f} vs Krumhansl {acc_kr:.3f}", flush=True)

    held_new = _heldout_keys(params, device)
    held_ok = True
    if held_new is not None:
        n_new, n_tot = held_new
        print(f"heldout keys: {n_new}/{n_tot} correct", flush=True)
        # as the JAX trainer: the ratchet reads the default checkpoint once --out exists
        old = kc.load_params() if Path(out_path).exists() else None
        if old is not None:
            n_old, _ = _heldout_keys(old, device)
            print(f"heldout keys (shipped checkpoint): {n_old}/{n_tot}", flush=True)
            held_ok = n_new >= n_old

    report = {"acc_cnn": acc_cnn, "acc_krumhansl": acc_kr, "heldout": held_new, "heldout_ok": held_ok}
    saved = accept(report)
    if saved:
        Path(out_path).parent.mkdir(parents=True, exist_ok=True)
        np.savez(out_path, **params)
        print(f"saved {out_path}", flush=True)
    else:
        print("NOT saved: CNN fails an acceptance gate", flush=True)
    return {**report, "params": params, "saved": saved}


def accept(report: dict) -> bool:
    """The save gate: held-out accuracy above the Krumhansl estimator's and no
    fewer held-out corpus keys than the shipped checkpoint."""
    return report["acc_cnn"] > report["acc_krumhansl"] and report["heldout_ok"]


_HELD_AUDIO: dict[tuple[str, str], torch.Tensor] = {}


def _heldout_keys(params, device: torch.device) -> tuple[int, int] | None:
    """(n_correct, n_total) over the committed held-out corpus, on the audio
    the pipeline feeds the key CNN: the HPSS harmonic of the mix for solo
    clips, of the htdemucs guitar stem for band clips."""
    import json

    from ..io.resample import resample_poly_host
    from ..io.wav import load_wav, peak_normalize
    from ..models.htdemucs import separate_stems_device

    wavs = heldout_wavs()
    if not wavs:
        return None
    n_ok = 0
    for wav in wavs:
        gt = json.loads(wav.with_suffix(".json").read_text())
        key = (str(wav), str(device))
        if key not in _HELD_AUDIO:
            y, sr0 = load_wav(wav)
            y = resample_poly_host(peak_normalize(y), sr0, SR)
            if gt.get("band"):
                stems = separate_stems_device(torch.from_numpy(y).to(device), SR, shifts=1)
                if stems is not None and "guitar" in stems:
                    y = stems["guitar"].cpu().numpy()
            _HELD_AUDIO[key] = _harmonic(y, device)
        label = kc.key_prediction_to_label(_probs(params, _HELD_AUDIO[key]).ravel())
        want = f"{['C','C#','D','D#','E','F','F#','G','G#','A','A#','B'][gt['key']['tonic_pc']]} {gt['key']['mode']}"
        ok = label == want
        n_ok += ok
        print(f"  {wav.stem}: {label} (want {want}){'' if ok else '  MISS'}", flush=True)
    return n_ok, len(wavs)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--clips", type=int, default=128)
    ap.add_argument("--steps", type=int, default=4000)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="build/weights/key_cnn.npz")
    device_arg(ap)
    args = ap.parse_args(argv)
    train(args.clips, args.steps, args.batch, args.seed, args.out, device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
