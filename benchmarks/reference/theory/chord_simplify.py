"""Chord simplification: collapse weak 7ths and tidy accompaniment triads.

Capability parity with the reference (reference: backend/app/services/
pipeline.py:1138-1279): a 7th chord collapses to its triad when it is
short/low-confidence, when the 7th's chroma energy is weak relative to the
triad tones, or when it is sandwiched between same-root triads; the
accompaniment variant force-triads everything and absorbs weak segments.

The port's copy of ``audiotabs_tpu/theory/chord_simplify.py``: host code, arithmetic unchanged.
"""

from __future__ import annotations

import numpy as np

from ..schemas import ChordSegment
from .vocabulary import NOTE_TO_PC, split_chord_label

_SEVENTHS = {"7", "min7", "maj7"}


def _triad_label(root: str, quality: str) -> str:
    minor = quality in ("min", "min7", "dim", "min7b5", "dim7", "min6", "min9")
    return f"{root}:{'min' if minor else 'maj'}"


def _segment_chroma_energy(chroma, times, start: float, end: float):
    if chroma is None or times is None:
        return None
    chroma = np.asarray(chroma)
    times = np.asarray(times)
    mask = (times >= start) & (times < end)
    if not mask.any():
        return None
    return chroma[:, mask].mean(axis=1)


def simplify_chord_segments(
    chords: list[ChordSegment],
    *,
    chroma=None,
    times=None,
    min_confidence: float = 0.05,
    min_duration: float = 1.0,
    seventh_ratio: float = 0.5,
) -> list[ChordSegment]:
    if not chords:
        return []
    confs = np.asarray([c.confidence for c in chords])
    conf_threshold = max(min_confidence, float(np.median(confs)) * 0.9)

    out: list[ChordSegment] = []
    for i, c in enumerate(chords):
        root, qual, _ = split_chord_label(c.label)
        if root is None or qual not in _SEVENTHS:
            out.append(c)
            continue

        collapse = (c.end - c.start) < min_duration or c.confidence < conf_threshold

        if not collapse:
            energy = _segment_chroma_energy(chroma, times, c.start, c.end)
            if energy is not None:
                root_pc = NOTE_TO_PC[root]
                third = 3 if qual == "min7" else 4
                triad = float(np.mean([energy[(root_pc + iv) % 12] for iv in (0, third, 7)]))
                seventh = float(energy[(root_pc + (11 if qual == "maj7" else 10)) % 12])
                if triad > 1e-6 and seventh < triad * seventh_ratio:
                    collapse = True

        if not collapse and 0 < i < len(chords) - 1:
            pr, pq, _ = split_chord_label(chords[i - 1].label)
            nr, nq, _ = split_chord_label(chords[i + 1].label)
            if pr == root and nr == root:
                if _triad_label(pr, pq or "maj") == _triad_label(root, qual) == _triad_label(nr, nq or "maj"):
                    collapse = True

        label = _triad_label(root, qual) if collapse else c.label
        out.append(ChordSegment(start=c.start, end=c.end, label=label, confidence=c.confidence))
    return out


def simplify_chords_for_accompaniment(
    chords: list[ChordSegment],
    *,
    min_duration: float = 0.6,
    min_confidence: float = 0.05,
) -> list[ChordSegment]:
    # operating point = the reference's (_ACC_MIN_SEGMENT_SEC 0.6,
    # _ACC_MIN_CONFIDENCE 0.05, pipeline.py:59-61): at 1.0 s the golden
    # WAV's 0.6 s N intro was absorbed into the opening G:maj, so the
    # intro pluck — which the reference leaves silent — emitted a full
    # G-chord strum (6 false-positive note events, r4's precision residual)
    if not chords:
        return []
    triads = []
    for c in chords:
        root, qual, _ = split_chord_label(c.label)
        if root is None:
            triads.append(c)
        else:
            triads.append(
                ChordSegment(start=c.start, end=c.end, label=_triad_label(root, qual or "maj"), confidence=c.confidence)
            )

    out: list[ChordSegment] = []
    i = 0
    while i < len(triads):
        seg = triads[i]
        weak = (seg.end - seg.start) < min_duration or seg.confidence < min_confidence
        if weak and i + 1 < len(triads):
            nxt = triads[i + 1]
            out.append(
                ChordSegment(
                    start=seg.start, end=nxt.end, label=nxt.label,
                    confidence=max(seg.confidence, nxt.confidence),
                )
            )
            i += 2
            continue
        if weak and out:
            prev = out[-1]
            out[-1] = ChordSegment(
                start=prev.start, end=seg.end, label=prev.label,
                confidence=max(prev.confidence, seg.confidence),
            )
            i += 1
            continue
        out.append(seg)
        i += 1

    merged: list[ChordSegment] = []
    for seg in out:
        if merged and seg.label == merged[-1].label:
            prev = merged[-1]
            merged[-1] = ChordSegment(
                start=prev.start, end=seg.end, label=prev.label,
                confidence=max(prev.confidence, seg.confidence),
            )
        else:
            merged.append(seg)
    return merged


def score_complexity_cost(score) -> float:
    """Readability heuristic for beat-grid selection (pipeline.py:1536-1559)."""
    items = [it for m in (score.measures or []) for it in (m.items or [])]
    if not items:
        return 1e9
    n_short = sum(1 for it in items if it.duration in ("16", "32"))
    n_ties = sum(1 for it in items if it.tie)
    non_rest = [it for it in items if not it.rest]
    avg_poly = float(np.mean([len(it.keys or []) for it in non_rest])) if non_rest else 0.0
    return (
        len(items)
        + 0.85 * n_short
        + 0.25 * n_ties
        + 0.35 * avg_poly
        + 0.6 * abs(len(score.measures or []) - 6.0)
    )


def pick_best_beat_times(note_events, beat_times, *, time_signature: str = "4/4"):
    """Try beats, beats[::2], beats[1::2]; keep the most readable notation
    (pipeline.py:1562-1608)."""
    from .quantize import quantize_note_events_to_score

    if beat_times is None or len(beat_times) < 2 or not note_events:
        return beat_times
    beats = np.asarray(beat_times, dtype=np.float32)
    beats = beats[np.isfinite(beats)]
    if beats.size < 2:
        return beat_times

    events = sorted(note_events, key=lambda e: e.start_time_s)
    if len(events) > 250:
        # selection only needs a representative sample; keep the loudest 250
        # in temporal order (the reference samples 600, pipeline.py:1577-1581)
        top = sorted(events, key=lambda e: -e.amplitude)[:250]
        events = sorted(top, key=lambda e: e.start_time_s)

    candidates = [beats]
    if beats.size >= 4:
        candidates += [beats[::2], beats[1::2]]

    best, best_cost = beats, None
    for cand in candidates:
        if cand.size < 2:
            continue
        try:
            q = quantize_note_events_to_score(
                events, tempo_bpm=120.0, beat_times=cand,
                time_signature=time_signature, with_tab=False,
            )
            cost = score_complexity_cost(q.score)
            # tempo prior: the tracker's range is 55-215 BPM; a candidate
            # grid implying a tempo outside it (e.g. half-time of a slow
            # song) must beat the in-range grid by a clear margin
            implied = tempo_from_beat_times(cand)
            if implied and not (55.0 <= implied <= 215.0):
                cost *= 2.0
        except Exception:
            continue
        if best_cost is None or cost < best_cost:
            best, best_cost = cand, cost
    return best.astype(np.float32)


def tempo_from_beat_times(beat_times) -> float:
    """Median-interval tempo (pipeline.py:1282-1290)."""
    if beat_times is None or len(beat_times) < 2:
        return 0.0
    diffs = np.diff(np.asarray(beat_times, dtype=np.float64))
    diffs = diffs[np.isfinite(diffs) & (diffs > 0)]
    if diffs.size == 0:
        return 0.0
    return float(60.0 / np.median(diffs))
