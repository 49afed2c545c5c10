"""Shared evaluation metrics: beat F-measure and note F-measure.

The port's copy of ``audiotabs_tpu/analysis/metrics.py`` (numpy, arithmetic
unchanged), used by the trainers' gates (train/*.py).
"""

from __future__ import annotations

import numpy as np


def beat_f_measure(est, ref, tol: float = 0.07) -> float:
    """Greedy one-to-one beat matching within ±tol seconds → F-measure.

    Each estimated beat matches the nearest still-unmatched reference beat
    within the tolerance.
    """
    est = np.asarray(est, dtype=np.float64)
    ref = np.asarray(ref, dtype=np.float64)
    if est.size == 0 or ref.size == 0:
        return 0.0
    matched: set[int] = set()
    tp = 0
    for e in est:
        d = np.abs(ref - e)
        order = np.argsort(d)
        for j in order[:4]:  # nearest few candidates
            if d[j] > tol:
                break
            if j not in matched:
                matched.add(int(j))
                tp += 1
                break
    p, r = tp / est.size, tp / ref.size
    return 2 * p * r / (p + r + 1e-12)


def note_f_measure(est, truth, tol: float = 0.05) -> float:
    """Onset ±tol seconds, pitch exact — over (start_s, pitch) pairs.

    ``est``: iterable of objects with .start_time_s/.pitch_midi OR
    (start, pitch[, ...]) tuples. ``truth``: (start, end, pitch) tuples or
    (start, pitch) pairs.
    """

    def norm_est(e):
        if hasattr(e, "pitch_midi"):
            return float(e.start_time_s), int(e.pitch_midi)
        return float(e[0]), int(e[-1])

    def norm_truth(t):
        return float(t[0]), int(t[-1])

    E = [norm_est(e) for e in est]
    T = [norm_truth(t) for t in truth]
    if not E or not T:
        return 0.0
    used: set[int] = set()
    tp = 0
    for t0, p0 in E:
        best, best_d = None, tol + 1
        for j, (t1, p1) in enumerate(T):
            if j in used or p1 != p0:
                continue
            d = abs(t1 - t0)
            if d <= tol and d < best_d:
                best, best_d = j, d
        if best is not None:
            used.add(best)
            tp += 1
    p, r = tp / len(E), tp / len(T)
    return 2 * p * r / (p + r + 1e-12)
