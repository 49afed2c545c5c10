"""Measure DEMUCS_SHIFTS=1 against 2 on the shipped checkpoint, on the card.

Counterpart of audiotabs_tpu/train/shifts_eval.py: the transcription stem's
SI-SDR on the trainer's held-out synthetic multitracks (seed 31000) at shifts
1 and 2 through ``separate_stems_device``. The JAX script's golden-WAV RMS
share needs a corpus the repo does not hold and is not ported
(train/golden.py).

Usage: python -m audiotabs_tpu_torch.train.shifts_eval [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from ..device import resolve_device
from ..models import htdemucs as hd
from .htdemucs_train import build_clips, si_sdr
from .optim import device_arg, no_tf32


def evaluate(device: str | torch.device | None = None, n_val: int = 8) -> dict | None:
    """The report of ``main`` as a dict, or None without a checkpoint."""
    device = resolve_device(device)
    params = hd.load_params()
    if params is None:
        return None
    n_sources = np.asarray(params["tdecoder"][-1]["convtr_w"]).shape[1] // 2
    names = hd.MODEL_STEMS["htdemucs_6s"][:n_sources]
    trans = "guitar" if n_sources >= 6 else "other"
    ti = names.index(trans)
    val_m, val_s, _ = build_clips(n_val, 31_000, n_sources=n_sources)
    report: dict = {"n_sources": n_sources, "stem": trans}
    with no_tf32():
        for shifts in (1, 2):
            t0 = time.time()
            sdrs = []
            for i in range(val_m.shape[0]):
                if float(np.abs(val_s[i, ti]).max()) <= 1e-6:
                    continue
                mono = torch.from_numpy(val_m[i].mean(axis=0).astype(np.float32)).to(device)
                stems = hd.separate_stems_device(mono, 44100, shifts=shifts)
                sdrs.append(si_sdr(stems[trans][: mono.shape[0]].cpu().numpy(), val_s[i, ti].mean(axis=0)))
            report[f"val_{trans}_sisdr_shifts{shifts}"] = round(float(np.mean(sdrs)), 3)
            report[f"wall_s_shifts{shifts}"] = round(time.time() - t0, 1)

    return report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    device_arg(ap)
    args = ap.parse_args(argv)
    report = evaluate(args.device)
    if report is None:
        print("no checkpoint", file=sys.stderr)
        return 1
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
