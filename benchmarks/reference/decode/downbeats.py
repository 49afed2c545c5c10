"""Downbeat and meter inference from tracked beats.

The reference carries a meter-inference stub fed by madmom beat positions
(reference: backend/app/services/grid/beats.py:46-58) but always emits 4/4
(pipeline.py:2038-2047). This module provides a working equivalent: given
beat times and the beat activation, test 3- and 4-beat bar hypotheses at
every phase, score each by the accent contrast between downbeat and
off-beat activations, and return (meter, downbeat times).

The port's copy of ``audiotabs_tpu/decode/downbeats.py``: host code, arithmetic unchanged.
"""

from __future__ import annotations

import numpy as np


def infer_meter_and_downbeats(
    beat_times: np.ndarray,
    activation: np.ndarray,
    fps: int = 100,
    *,
    candidates: tuple[int, ...] = (3, 4),
    min_advantage: float = 1.05,
) -> tuple[str, np.ndarray]:
    """→ (time signature "3/4"|"4/4", downbeat times).

    Accent score for (beats-per-bar b, phase p) = mean activation on beats
    p, p+b, p+2b … divided by the mean on the remaining beats. 4/4 wins
    ties (the overwhelmingly common meter, and the reference's default).
    """
    bt = np.asarray(beat_times, dtype=np.float64)
    act = np.asarray(activation, dtype=np.float64)
    if bt.size < 6 or act.size == 0:
        return "4/4", bt[:1] if bt.size else np.asarray([])

    frames = np.clip((bt * fps).astype(int), 0, len(act) - 1)
    strengths = act[frames]

    best = ("4/4", bt[0::4], 0.0)
    for b in candidates:
        for phase in range(b):
            on = strengths[phase::b]
            off = np.delete(strengths, np.arange(phase, len(strengths), b))
            if on.size == 0 or off.size == 0:
                continue
            score = float(np.mean(on) / (np.mean(off) + 1e-9))
            # prefer 4/4 unless 3/4 is clearly better
            eff = score if b == 4 else score / min_advantage
            if eff > best[2]:
                best = (f"{b}/4", bt[phase::b], eff)
    return best[0], np.asarray(best[1], dtype=np.float32)
