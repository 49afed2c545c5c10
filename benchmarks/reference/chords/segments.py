"""Frame-path → chord segments: beat-sync smoothing, run splitting, merging.

Capability parity with the reference (reference: backend/app/services/
chords/extract.py:103-114 beat-sync majority vote; chords/template.py:
140-195 run splitting + min-length absorption).

The port's copy of ``audiotabs_tpu/chords/segments.py``: host code, arithmetic unchanged.
"""

from __future__ import annotations

import numpy as np

from ..schemas import ChordSegment


def beat_sync_majority(path: np.ndarray, emissions: np.ndarray, beat_times, fps: float):
    """Majority-vote the decoded state inside each beat interval."""
    path = np.asarray(path).copy()
    if beat_times is None or len(beat_times) < 2:
        conf = emissions[path, np.arange(len(path))]
        return path, conf
    T = len(path)
    bf = np.round(np.asarray(beat_times, dtype=np.float64) * fps).astype(int)
    bf = bf[(bf > 0) & (bf < T)]
    bounds = np.unique(np.concatenate(([0], bf, [T])))
    for a, b in zip(bounds[:-1], bounds[1:]):
        seg = path[a:b]
        if seg.size == 0:
            continue
        vals, cnts = np.unique(seg, return_counts=True)
        path[a:b] = vals[int(np.argmax(cnts))]
    conf = emissions[path, np.arange(T)]
    return path, conf.astype(np.float32)


def frames_to_segments(
    path: np.ndarray,
    conf: np.ndarray,
    times: np.ndarray,
    labels: tuple[str, ...],
    min_len: float = 0.25,
) -> list[ChordSegment]:
    """Split the frame path into constant-state runs; absorb short runs into
    the higher-confidence neighbor."""
    path = np.asarray(path)
    if path.size == 0:
        return []
    step = float(times[1] - times[0]) if len(times) > 1 else 0.02

    change = np.flatnonzero(np.diff(path)) + 1
    starts = np.concatenate(([0], change))
    ends = np.concatenate((change, [len(path)]))
    segs = [
        {
            "start": float(times[a]),
            "end": float(times[b - 1] + step),
            "state": int(path[a]),
            "conf": float(np.mean(conf[a:b])),
        }
        for a, b in zip(starts, ends)
    ]

    i = 0
    while i < len(segs):
        if segs[i]["end"] - segs[i]["start"] < min_len and len(segs) > 1:
            if i == 0:
                j = 1
            elif i == len(segs) - 1:
                j = i - 1
            else:
                j = i - 1 if segs[i - 1]["conf"] >= segs[i + 1]["conf"] else i + 1
            if j < i:
                segs[j]["end"] = segs[i]["end"]
            else:
                segs[j]["start"] = segs[i]["start"]
            segs[j]["conf"] = max(segs[j]["conf"], segs[i]["conf"])
            segs.pop(i)
            i = max(i - 1, 0)
            continue
        i += 1

    return [
        ChordSegment(
            start=s["start"], end=s["end"], label=labels[s["state"]], confidence=s["conf"]
        )
        for s in segs
    ]
