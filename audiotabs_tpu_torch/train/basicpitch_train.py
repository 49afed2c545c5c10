"""Train the Basic Pitch CNN (models/basicpitch.py) on synthetic note clips, on the card.

Counterpart of audiotabs_tpu/train/basicpitch_train.py: the same clips
(train/synth: guitar voicings and varied-timbre note clips, from the same
numpy seeds), onset/frame/contour rolls, the hCQT computed on the device per
batch, the three weighted BCEs (onset ×12, frame and contour ×4, the contour
term twice), Adam under a cosine-decayed rate (alpha 0.05), and the same
save gates: held-out note F above the salience baseline (the committed
held-out corpus when present), the pure-tone smoke, and the ratchet against
an existing checkpoint. The JAX trainer's informational golden-WAV readings
(chord parity, note recall) need a corpus the repo does not hold and are not
ported (train/golden.py). The checkpoint is the JAX trainer's flat npz.

Usage:
    python -m audiotabs_tpu_torch.train.basicpitch_train \
        [--clips 48] [--steps 600] [--device cuda] [--out build/weights/basicpitch.npz]
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import numpy as np
import torch

from ..analysis.metrics import note_f_measure
from ..device import resolve_device
from ..models import basicpitch as bp
from . import heldout_wavs
from .optim import Trainer, device_arg, no_tf32

SR = 22050
CLIP_S = 4.0
FPS = SR / bp.HOP  # ≈ 86.1


def rolls_from_events(events, n_frames: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """[(start, end, pitch)] → (onset [T, 88], frame [T, 88], contour [T, 264]).

    The contour roll supervises the 3-bins-per-semitone salience head directly."""
    onset = np.zeros((n_frames, 88), dtype=np.float32)
    frame = np.zeros((n_frames, 88), dtype=np.float32)
    contour = np.zeros((n_frames, bp.N_BINS), dtype=np.float32)
    for start, end, pitch in events:
        p = pitch - bp.MIDI_A0
        if not 0 <= p < 88:
            continue
        a = int(round(start * FPS))
        b = max(a + 1, int(round(end * FPS)))
        if a >= n_frames:
            continue
        b = min(b, n_frames)
        frame[a:b, p] = 1.0
        c = p * bp.BINS_PER_SEMITONE + 1  # centre sub-bin
        contour[a:b, c] = 1.0
        for dc in (-1, 1):
            if 0 <= c + dc < bp.N_BINS:
                contour[a:b, c + dc] = np.maximum(contour[a:b, c + dc], 0.5)
        onset[a, p] = 1.0
        if a + 1 < n_frames:
            onset[a + 1, p] = max(onset[a + 1, p], 0.5)
    return onset, frame, contour


def build_clips(n: int, seed: int, voicing_frac: float = 0.5):
    """Half the clips guitar voicings, the rest note clips (a third of them 4-voice)."""
    from .synth import synth_guitar_voicing_clip, synth_note_clip

    rng = np.random.default_rng(seed)
    clips = []
    for _ in range(n):
        if rng.uniform() < voicing_frac:
            y, events = synth_guitar_voicing_clip(rng, CLIP_S, SR)
        else:
            poly = 4 if rng.uniform() < 0.33 else 3
            y, events = synth_note_clip(rng, CLIP_S, SR, polyphony=poly)
        clips.append((y, events))
    return clips


def decode_events(onset, frame, on_thr=0.5, fr_thr=0.3):
    return bp.notes_from_posteriors(np.asarray(onset, np.float32), np.asarray(frame, np.float32), fps=FPS,
                                    onset_threshold=on_thr, frame_threshold=fr_thr, min_note_ms=80.0)


def loss_fn(net: bp.BasicPitchCNN, yb: torch.Tensor, ob: torch.Tensor, fb: torch.Tensor, cb: torch.Tensor) -> torch.Tensor:
    """Audio [B, N] and rolls → the mean over clips of the three weighted BCEs."""
    onset, frame, contour = net(bp.hcqt(yb, SR))  # [B, T, ·]
    T = min(onset.shape[1], ob.shape[1])
    onset = torch.clamp(onset[:, :T], 1e-6, 1 - 1e-6)
    frame = torch.clamp(frame[:, :T], 1e-6, 1 - 1e-6)
    contour = torch.clamp(contour[:, :T], 1e-6, 1 - 1e-6)
    o_t, f_t, c_t = ob[:, :T], fb[:, :T], cb[:, :T]
    bce_o = -(12.0 * o_t * torch.log(onset) + (1 - o_t) * torch.log(1 - onset))
    bce_f = -(4.0 * f_t * torch.log(frame) + (1 - f_t) * torch.log(1 - frame))
    bce_c = -(4.0 * c_t * torch.log(contour) + (1 - c_t) * torch.log(1 - contour))
    return (bce_o.mean(dim=(1, 2)) + bce_f.mean(dim=(1, 2)) + 2.0 * bce_c.mean(dim=(1, 2))).mean()


def update(net, trainer: Trainer, *batch) -> torch.Tensor:
    loss = loss_fn(net, *batch)
    loss.backward()
    trainer.step()
    return loss.detach()


def _posteriors(params, y: torch.Tensor):
    """(onset, frame) posteriors of ``y`` on its device: the CNN of
    ``params``, or the salience baseline when ``params`` is None."""
    with torch.inference_mode(), no_tf32():
        if params is None:
            onset, frame = bp.salience_posteriors(y, SR)
        else:
            onset, frame, _ = bp.BasicPitchCNN.from_params(params).to(y.device).eval()(bp.hcqt(y, SR))
        return onset.cpu().numpy(), frame.cpu().numpy()


def train(n_clips: int = 48, steps: int = 600, batch: int = 8, seed: int = 0,
          out_path: str = "build/weights/basicpitch.npz", device: str | torch.device | None = None) -> dict:
    device = resolve_device(device)
    t0 = time.time()
    clips = build_clips(n_clips, seed)
    val_clips = build_clips(12, seed + 77_000)
    n_frames = int(CLIP_S * SR) // bp.HOP + 1
    audio = np.stack([c[0] for c in clips]).astype(np.float32)
    onsets = np.zeros((n_clips, n_frames, 88), np.float32)
    frames = np.zeros((n_clips, n_frames, 88), np.float32)
    contours = np.zeros((n_clips, n_frames, bp.N_BINS), np.float32)
    for i, (_, ev) in enumerate(clips):
        onsets[i], frames[i], contours[i] = rolls_from_events(ev, n_frames)
    print(f"dataset: {audio.shape} audio, {n_frames} frames/clip ({time.time()-t0:.0f}s)", flush=True)

    template = bp.init_params(torch.Generator().manual_seed(seed))
    net = bp.BasicPitchCNN.from_params(template).to(device)
    trainer = Trainer(net.parameters(), 3e-3, steps, alpha=0.05)
    rng = np.random.default_rng(seed)
    with no_tf32():
        for step in range(steps):
            sel = rng.choice(n_clips, size=batch, replace=False)
            loss = update(net, trainer, *(torch.from_numpy(a[sel]).to(device) for a in (audio, onsets, frames, contours)))
            if step % 100 == 0 or step == steps - 1:
                print(f"step {step}: loss {float(loss):.4f} ({time.time()-t0:.0f}s)", flush=True)
    params = bp.params_of(net, template)

    def eval_f(p) -> float:
        return float(np.mean([note_f_measure(decode_events(*_posteriors(p, torch.from_numpy(y).to(device))), ev)
                              for y, ev in val_clips]))

    f_cnn, f_sal = eval_f(params), eval_f(None)
    print(f"val note F: CNN {f_cnn:.3f} vs salience baseline {f_sal:.3f}", flush=True)
    ok_tone = _pure_tone_smoke(params, device)
    print(f"pure-tone smoke: {'ok' if ok_tone else 'FAIL'}", flush=True)

    def _hf(pr):
        r, p = pr
        return 2 * r * p / (r + p + 1e-12)

    pr_raw = _heldout_note_pr(params, device, production=False)
    if pr_raw is not None:
        print(f"[info] heldout RAW-decode-on-mix recall {pr_raw[0]:.3f} precision {pr_raw[1]:.3f} F {_hf(pr_raw):.3f}", flush=True)
    pr = _heldout_note_pr(params, device)
    ratchet_ok = True
    beats_baseline = f_cnn > f_sal
    if pr is not None:
        f_new = _hf(pr)
        print(f"heldout note recall {pr[0]:.3f} precision {pr[1]:.3f} F {f_new:.3f}", flush=True)
        pr_sal = _heldout_note_pr(None, device)
        if pr_sal is not None:
            print(f"heldout salience baseline F: {_hf(pr_sal):.3f}", flush=True)
            beats_baseline = f_new > _hf(pr_sal)
        if Path(out_path).exists():
            old = bp.load_params(str(out_path))
            if old is not None:
                pr_old = _heldout_note_pr(old, device)
                if pr_old is not None:
                    f_old = _hf(pr_old)
                    print(f"existing checkpoint heldout F: {f_old:.3f}", flush=True)
                    ratchet_ok = f_new >= f_old - 1e-6

    report = {"f_cnn": f_cnn, "f_sal": f_sal, "pure_tone_ok": ok_tone, "beats_baseline": beats_baseline,
              "ratchet_ok": ratchet_ok}
    saved = accept(report)
    if saved:
        Path(out_path).parent.mkdir(parents=True, exist_ok=True)
        np.savez(out_path, **params)
        print(f"saved {out_path}", flush=True)
    else:
        print("NOT saved: CNN fails an acceptance gate", flush=True)
    return {**report, "params": params, "saved": saved}


def accept(report: dict) -> bool:
    """The save gate: note F above the salience baseline's (on the held-out
    corpus when present), the pure-tone smoke, and no regression against an
    existing checkpoint."""
    return report["beats_baseline"] and report["pure_tone_ok"] and report["ratchet_ok"]


def _pure_tone_smoke(params, device: torch.device) -> bool:
    """A plain-sine C-major chord and a C → G sine sequence must decode to their pitches."""
    t = np.arange(int(SR * 1.5)) / SR
    chord = sum(0.3 * np.sin(2 * np.pi * 440.0 * 2 ** ((p - 69) / 12) * t) for p in (60, 64, 67)).astype(np.float32)
    got = {e.pitch_midi for e in decode_events(*_posteriors(params, torch.from_numpy(chord).to(device)))}
    if not {60, 64, 67} <= got:
        return False
    seq = np.concatenate([(0.3 * np.sin(2 * np.pi * 440.0 * 2 ** ((p - 69) / 12) * t)).astype(np.float32) for p in (60, 67)])
    est = sorted(decode_events(*_posteriors(params, torch.from_numpy(seq).to(device))), key=lambda e: e.start_time_s)
    return bool(est) and est[0].pitch_midi == 60 and est[-1].pitch_midi == 67


_HELDOUT_AUDIO: dict = {}


def _heldout_amt_input(wav, band: bool, device: torch.device) -> torch.Tensor:
    """What the pipeline feeds the AMT on a held-out clip: the HPSS harmonic
    of the htdemucs guitar stem for a band mix, of the mix for a solo clip."""
    from ..io.resample import resample_poly_host
    from ..io.wav import load_wav, peak_normalize
    from ..ops.hpss import hpss

    key = (str(wav), str(device))
    if key not in _HELDOUT_AUDIO:
        y, sr0 = load_wav(wav)
        yd = torch.from_numpy(resample_poly_host(peak_normalize(y), sr0, SR)).to(device)
        if band:
            from ..models.htdemucs import separate_stems_device

            stems = separate_stems_device(yd, SR, shifts=1)
            if stems is not None and "guitar" in stems:
                yd = stems["guitar"].float().contiguous()
        _HELDOUT_AUDIO[key] = hpss(yd)[0]
    return _HELDOUT_AUDIO[key]


def _heldout_note_pr(params, device: torch.device, *, production: bool = True) -> tuple[float, float] | None:
    """(recall, precision) of the decoded events against the exact note
    ground truth of the committed held-out corpus (onset ±50 ms, pitch
    exact); ``params=None`` is the salience baseline. ``production`` takes
    the pipeline's input and its harmonic-duplicate filter; otherwise the
    raw decode on the HPSS harmonic of the mix."""
    import json

    from ..io.resample import resample_poly_host
    from ..io.wav import load_wav, peak_normalize
    from ..ops.hpss import hpss
    from ..theory.postprocess import remove_harmonic_duplicates

    wavs = heldout_wavs()
    if not wavs:
        return None
    rs, ps = [], []
    for wav in wavs:
        meta = json.loads(wav.with_suffix(".json").read_text())
        gt = meta["notes"]
        if production:
            yh = _heldout_amt_input(wav, bool(meta.get("band")), device)
        else:
            y, sr0 = load_wav(wav)
            yh = hpss(torch.from_numpy(resample_poly_host(peak_normalize(y), sr0, SR)).to(device))[0]
        est = decode_events(*_posteriors(params, yh))
        if production:
            est = remove_harmonic_duplicates(est)
        hit = sum(1 for g in gt if any(e.pitch_midi == g["pitch"] and abs(e.start_time_s - g["start"]) <= 0.05 for e in est))
        phit = sum(1 for e in est if any(g["pitch"] == e.pitch_midi and abs(g["start"] - e.start_time_s) <= 0.05 for g in gt))
        rs.append(hit / max(len(gt), 1))
        ps.append(phit / max(len(est), 1))
    return float(np.mean(rs)), float(np.mean(ps))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--clips", type=int, default=48)
    ap.add_argument("--steps", type=int, default=600)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="build/weights/basicpitch.npz")
    device_arg(ap)
    args = ap.parse_args(argv)
    res = train(args.clips, args.steps, args.batch, args.seed, args.out, device=args.device)
    return 0 if res["f_cnn"] > 0 else 1


if __name__ == "__main__":
    sys.exit(main())
