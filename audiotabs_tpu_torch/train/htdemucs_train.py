"""Train HTDemucs (models/htdemucs.py) on synthetic multitracks, on the card.

Counterpart of audiotabs_tpu/train/htdemucs_train.py: the same clips
(train/synth.synth_multitrack from the same numpy seeds), the same batches
(numpy ``default_rng(seed).choice``), the per-clip per-stem level-normalised
L1 plus twice the mix-reconstruction L1, Adam under a cosine-decayed rate
(alpha 0.1), and the same save gates: the transcription stem's held-out
SI-SDR must beat the HPSS-harmonic baseline, the beat F of a DBN decode on
the separated drums must match the HPSS-percussive baseline. The JAX trainer's
golden-WAV gates and ratchets need a corpus the repo does not hold and are
not ported (train/golden.py).

The net is the port's ``HTDemucs`` module, built here from the pytree (never
the cached serving module), its weights written back to the JAX layout with
``meta_segment`` for the checkpoint, which both packages load.

Usage:
    python -m audiotabs_tpu_torch.train.htdemucs_train \
        [--sources 6] [--clips 48] [--steps 1500] [--device cuda] \
        [--out build/weights/htdemucs.npz]
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import numpy as np
import torch

from ..device import resolve_device
from ..models import htdemucs as hd
from .optim import StepTimer, Trainer, device_arg, no_tf32

SR = 44100
SEG = 131072  # ≈ 2.97 s, multiple of ALIGN


def si_sdr(est: np.ndarray, ref: np.ndarray) -> float:
    """Scale-invariant SDR in dB over flattened [ch, T]."""
    est = est.reshape(-1).astype(np.float64)
    ref = ref.reshape(-1).astype(np.float64)
    denom = np.dot(ref, ref) + 1e-12
    s = (np.dot(est, ref) / denom) * ref
    e = est - s
    return float(10 * np.log10((np.dot(s, s) + 1e-12) / (np.dot(e, e) + 1e-12)))


def build_clips(n: int, seed: int, duration: float | None = None, n_sources: int = 4):
    """→ (mixes [n, 2, seg], stems [n, S, 2, seg], beat times per clip), numpy."""
    from .synth import synth_multitrack

    seg = SEG if duration is None else int(duration * SR)
    rng = np.random.default_rng(seed)
    mixes = np.zeros((n, 2, seg), np.float32)
    stems = np.zeros((n, n_sources, 2, seg), np.float32)
    beats = []
    for i in range(n):
        m, s, b = synth_multitrack(rng, seg / SR + 0.05, SR, n_sources=n_sources)
        mixes[i] = m[:, :seg]
        stems[i] = s[:, :, :seg]
        beats.append(b[b < seg / SR])
    return mixes, stems, beats


def hpss_baseline(mix: np.ndarray, device: torch.device) -> dict[str, np.ndarray]:
    """The pipeline's weight-free fallback: HPSS percussive → drums,
    harmonic → transcription stem (per channel, on ``device``)."""
    from ..ops.hpss import hpss

    outs = {"drums": np.zeros_like(mix), "harmonic": np.zeros_like(mix)}
    for c in range(mix.shape[0]):
        yh, yp = hpss(torch.from_numpy(np.ascontiguousarray(mix[c])).to(device))
        outs["harmonic"][c] = yh.cpu().numpy()
        outs["drums"][c] = yp.cpu().numpy()
    return outs


def loss_fn(net: hd.HTDemucs, mb: torch.Tensor, sb: torch.Tensor) -> torch.Tensor:
    """mixes [B, 2, T], stems [B, S, 2, T] → the scalar training loss.

    Per-clip per-stem L1 normalised by the stem's level (+0.02, so silent
    stems of solo arrangements do not dominate), plus twice the L1 of the
    stems' sum against the mix."""
    pred = net(mb)  # [B, S, 2, T]
    err = (pred - sb).abs().mean(dim=(2, 3))
    level = sb.abs().mean(dim=(2, 3)) + 0.02
    recon = (pred.sum(dim=1) - mb).abs().mean()
    return (err / level).mean() + 2.0 * recon


def trainable(params: dict, device: torch.device) -> hd.HTDemucs:
    """A fresh, trainable module of ``params`` (not the cached serving one)."""
    run = {k: v for k, v in params.items() if k != "meta_segment"}
    return hd.HTDemucs.from_params(run).to(device).requires_grad_(True).train()


def train(
    n_clips: int = 48,
    steps: int = 1500,
    batch: int = 4,
    seed: int = 0,
    out_path: str = "build/weights/htdemucs.npz",
    channels: int = 16,
    bottom: int = 128,
    t_layers: int = 3,
    sources: int = 4,
    resume: bool = False,
    lr: float = 3e-4,
    device: str | torch.device | None = None,
    n_val: int = 8,
) -> dict:
    """Train, evaluate the gates, and save when they pass. ``n_val`` is the
    held-out clip count (8 in the JAX trainer). Returns the gate numbers, the
    JAX-layout params, every step's loss and time (``losses``, ``step_ms``)."""
    device = resolve_device(device)
    t0 = time.time()
    names = hd.MODEL_STEMS["htdemucs_6s"][:sources]
    trans_name = "guitar" if sources >= 6 else "other"
    trans_idx = names.index(trans_name)
    mixes, stems, _ = build_clips(n_clips, seed, n_sources=sources)
    val_m, val_s, val_beats = build_clips(n_val, seed + 31_000, n_sources=sources)
    print(f"dataset: {mixes.shape} mixes, stems {names} ({time.time()-t0:.0f}s)", flush=True)

    if resume and Path(out_path).exists():
        prev = hd.load_params(out_path)
        prev_sources = np.asarray(prev["tdecoder"][-1]["convtr_w"]).shape[1] // 2
        if prev_sources != sources:
            raise ValueError(f"--resume checkpoint has {prev_sources} sources, asked {sources}")
        params0 = {k: v for k, v in prev.items() if k != "meta_segment"}
        print(f"resumed from {out_path}", flush=True)
    else:
        params0 = hd.init_params(torch.Generator().manual_seed(seed), n_sources=sources,
                                 channels=channels, bottom=bottom, t_layers=t_layers)
    net = trainable(params0, device)
    n_params = sum(p.numel() for p in net.parameters())
    print(f"model: {n_params/1e6:.2f}M params", flush=True)
    trainer = Trainer(net.parameters(), lr, steps, alpha=0.1)

    rng = np.random.default_rng(seed)
    losses, timer = [], StepTimer(device)
    with no_tf32():
        timer.mark()
        for step in range(steps):
            sel = rng.choice(n_clips, size=batch, replace=False)
            loss = loss_fn(net, torch.from_numpy(mixes[sel]).to(device), torch.from_numpy(stems[sel]).to(device))
            loss.backward()
            trainer.step()
            losses.append(loss.detach())
            timer.mark()
            if step % 100 == 0 or step == steps - 1:
                print(f"step {step}: L1 {float(losses[-1]):.5f} ({time.time()-t0:.0f}s)", flush=True)
        losses = [float(x) for x in losses]
        step_ms = timer.ms()
        net.eval()
        gates = _gates(net, val_m, val_s, val_beats, names, trans_name, trans_idx, device)
    params = {**hd.params_of(net, params0), "meta_segment": np.asarray(SEG, dtype=np.int64)}
    gates["saved"] = accept(gates)
    if gates["saved"]:
        Path(out_path).parent.mkdir(parents=True, exist_ok=True)
        hd.save_params(out_path, params)
        print(f"saved {out_path}", flush=True)
    else:
        print("NOT saved: model fails an acceptance gate", flush=True)
    return {**gates, "params": params, "losses": losses, "step_ms": step_ms}


def _gates(net, val_m, val_s, val_beats, names, trans_name, trans_idx, device) -> dict:
    """The JAX trainer's evaluation: SI-SDR per stem against the HPSS
    baseline and beat F from the separated drums."""
    from ..analysis.metrics import beat_f_measure
    from ..decode.dbn_beats import dbn_beat_track
    from ..models.beat_rnn import onset_activation

    def fwd(model, m: np.ndarray) -> np.ndarray:
        with torch.inference_mode():
            return model(torch.from_numpy(m).to(device)).cpu().numpy()

    def beats_from(drums_lr: np.ndarray) -> np.ndarray:
        with torch.inference_mode():
            act = onset_activation(torch.from_numpy(drums_lr.mean(axis=0)).to(device), SR, 100)
        return dbn_beat_track(act)

    ours = {k: [] for k in names}
    base = {"drums": [], trans_name: []}
    beat_ours, beat_base = [], []
    for i in range(val_m.shape[0]):
        pred = fwd(net, val_m[i])
        for k, name in enumerate(names):
            if float(np.abs(val_s[i, k]).max()) > 1e-6:  # skip silent stems
                ours[name].append(si_sdr(pred[k], val_s[i, k]))
        hb = hpss_baseline(val_m[i], device)
        if float(np.abs(val_s[i, 0]).max()) > 1e-6:
            base["drums"].append(si_sdr(hb["drums"], val_s[i, 0]))
        if float(np.abs(val_s[i, trans_idx]).max()) > 1e-6:
            base[trans_name].append(si_sdr(hb["harmonic"], val_s[i, trans_idx]))
        beat_ours.append(beat_f_measure(beats_from(pred[0]), val_beats[i]))
        beat_base.append(beat_f_measure(beats_from(hb["drums"]), val_beats[i]))
    ours_m = {k: float(np.mean(v)) for k, v in ours.items() if v}
    base_m = {k: float(np.mean(v)) for k, v in base.items() if v}
    bf_ours, bf_base = float(np.mean(beat_ours)), float(np.mean(beat_base))
    print(f"val SI-SDR (dB): model {ours_m}", flush=True)
    print(f"val SI-SDR (dB): HPSS baseline {base_m}", flush=True)
    print(f"val beat F from separated drums: model {bf_ours:.3f} vs HPSS {bf_base:.3f}", flush=True)

    # the JAX trainer's golden gates and ratchets run only with the golden corpus
    gates_ok = ours_m.get(trans_name, -np.inf) > base_m.get(trans_name, np.inf) and bf_ours >= bf_base
    return {"ours": ours_m, "base": base_m, "beat_f": bf_ours, "beat_f_base": bf_base, "gates_ok": bool(gates_ok)}


def accept(report: dict) -> bool:
    """The save gate: the transcription stem's SI-SDR above the HPSS
    baseline's and the drums' beat F at least the baseline's (``gates_ok``)."""
    return report["gates_ok"]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--clips", type=int, default=48)
    ap.add_argument("--steps", type=int, default=1500)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--sources", type=int, default=4, choices=(4, 6))
    ap.add_argument("--channels", type=int, default=16)
    ap.add_argument("--bottom", type=int, default=128)
    ap.add_argument("--t-layers", type=int, default=3)
    ap.add_argument("--resume", action="store_true", help="init from the existing --out checkpoint (same arch)")
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--out", default="build/weights/htdemucs.npz")
    device_arg(ap)
    args = ap.parse_args(argv)
    train(args.clips, args.steps, args.batch, args.seed, args.out, channels=args.channels, bottom=args.bottom,
          t_layers=args.t_layers, sources=args.sources, resume=args.resume, lr=args.lr, device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
