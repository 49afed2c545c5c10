"""Quantization: note events → ScoreData (measures of VexFlow-style items).

Replaces the reference's music21-based quantizer (reference: backend/app/
services/theory/quantize.py:382-581) with a self-contained implementation:

  1. key estimate (Krumhansl, theory/key.py) for enharmonic spelling;
  2. beat-warp event times into quarter-note space via interp with linear
     extrapolation outside the beat grid (quantize.py:190-233 semantics);
  3. per-pitch gap merge (quantize.py:292-328);
  4. grid snap of onsets/durations to quarter-length divisors (4, 3) — the
     behavior of music21's ``part.quantize(quarterLengthDivisors=(4, 3))``;
  5. chordify: a boundary sweep producing (pitch-set, duration) runs — the
     behavior of ``part.chordify()`` (quantize.py:331-379);
  6. measure packing with greedy duration decomposition, dotted/triplet
     tokens, and ties across barlines (quantize.py:447-521);
  7. DP tab-position assignment via tab/optimizer.py.

The port's copy of ``audiotabs_tpu/theory/quantize.py``: host code, arithmetic unchanged.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Literal, Optional

import numpy as np

from ..schemas import KeySignature, ScoreData, ScoreItem, ScoreMeasure, TupletSpec
from ..tab.fretboard import get_tuning
from ..tab.optimizer import optimize_tab_positions_for_events
from .events import NoteEvent
from .key import estimate_key_from_events

VF_NOTE_NAMES_SHARP = ["c", "c#", "d", "d#", "e", "f", "f#", "g", "g#", "a", "a#", "b"]
VF_NOTE_NAMES_FLAT = ["c", "db", "d", "eb", "e", "f", "gb", "g", "ab", "a", "bb", "b"]


def midi_to_vexflow_key(pitch_midi: int, *, use_flats: bool) -> str:
    pc = int(pitch_midi) % 12
    octave = int(pitch_midi) // 12 - 1
    name = (VF_NOTE_NAMES_FLAT if use_flats else VF_NOTE_NAMES_SHARP)[pc]
    return f"{name}/{octave}"


def vexflow_key_to_midi(key: str) -> int | None:
    try:
        note, octave_s = key.split("/")
        note = note.strip().lower()
        if note in VF_NOTE_NAMES_SHARP:
            pc = VF_NOTE_NAMES_SHARP.index(note)
        elif note in VF_NOTE_NAMES_FLAT:
            pc = VF_NOTE_NAMES_FLAT.index(note)
        else:
            return None
        return (int(octave_s) + 1) * 12 + pc
    except Exception:
        return None


@dataclass(frozen=True)
class DurToken:
    duration: str
    dots: int
    ql: float
    tuplet: tuple[int, int] | None


DUR_TOKENS_STRAIGHT = [
    DurToken("w", 0, 4.0, None),
    DurToken("h", 1, 3.0, None),
    DurToken("h", 0, 2.0, None),
    DurToken("q", 1, 1.5, None),
    DurToken("q", 0, 1.0, None),
    DurToken("8", 1, 0.75, None),
    DurToken("8", 0, 0.5, None),
    DurToken("16", 1, 0.375, None),
    DurToken("16", 0, 0.25, None),
    DurToken("32", 1, 0.1875, None),
    DurToken("32", 0, 0.125, None),
]
DUR_TOKENS_TRIPLET = [
    DurToken("w", 0, 8.0 / 3.0, (3, 2)),
    DurToken("h", 0, 4.0 / 3.0, (3, 2)),
    DurToken("q", 0, 2.0 / 3.0, (3, 2)),
    DurToken("8", 0, 1.0 / 3.0, (3, 2)),
    DurToken("16", 0, 1.0 / 6.0, (3, 2)),
    DurToken("32", 0, 1.0 / 12.0, (3, 2)),
]
DUR_TOKENS_ALL = sorted(
    DUR_TOKENS_STRAIGHT + DUR_TOKENS_TRIPLET, key=lambda t: (-t.ql, t.tuplet is not None)
)


def decompose_duration(duration_q: float) -> list[DurToken]:
    """Greedy largest-first decomposition of a quarter-length into tokens."""
    out: list[DurToken] = []
    rem = float(duration_q)
    eps = 1e-6
    for token in DUR_TOKENS_ALL:
        while rem + eps >= token.ql:
            out.append(token)
            rem -= token.ql
    if rem > 1e-3:
        out.append(DUR_TOKENS_ALL[-1])
    return out


def duration_to_quarters(item: ScoreItem) -> float:
    base_map = {"w": 4.0, "h": 2.0, "q": 1.0, "8": 0.5, "16": 0.25, "32": 0.125}
    base = base_map.get(str(item.duration), 0.0)
    total = base
    for i in range(int(item.dots or 0)):
        total += base / 2 ** (i + 1)
    if item.tuplet is not None and item.tuplet.num_notes and item.tuplet.notes_occupied:
        total *= item.tuplet.notes_occupied / item.tuplet.num_notes
    return total


def parse_time_signature(time_signature: str) -> tuple[int, int]:
    try:
        num_s, den_s = (time_signature or "4/4").split("/")
        num, den = int(num_s), int(den_s)
        if num <= 0 or den <= 0:
            raise ValueError
        return num, den
    except Exception:
        return 4, 4


def to_beats(times_s: np.ndarray, beat_times: np.ndarray) -> np.ndarray:
    """Map seconds → fractional beat index, extrapolating at the mean period."""
    beats = np.sort(np.asarray(beat_times, dtype=np.float64))
    beats = beats[np.isfinite(beats)]
    times_s = np.asarray(times_s, dtype=np.float64)
    idx = np.arange(len(beats), dtype=np.float64)
    avg = float(np.mean(np.diff(beats))) if len(beats) > 1 else 0.5
    avg = avg if avg > 0 else 0.5
    res = np.interp(times_s, beats, idx)
    lo = times_s < beats[0]
    res[lo] = (times_s[lo] - beats[0]) / avg
    hi = times_s > beats[-1]
    res[hi] = idx[-1] + (times_s[hi] - beats[-1]) / avg
    return res


def beats_to_seconds(beat_pos: float, beat_times: np.ndarray | None, tempo_bpm: float) -> float:
    """Inverse of to_beats for a scalar position."""
    if beat_times is None or len(np.atleast_1d(beat_times)) < 2:
        tempo = tempo_bpm if tempo_bpm and tempo_bpm > 0 else 120.0
        return float(beat_pos) * 60.0 / tempo
    beats = np.sort(np.asarray(beat_times, dtype=np.float64))
    beats = beats[np.isfinite(beats)]
    if beats.size < 2:
        tempo = tempo_bpm if tempo_bpm and tempo_bpm > 0 else 120.0
        return float(beat_pos) * 60.0 / tempo
    idx = np.arange(len(beats), dtype=np.float64)
    avg = float(np.mean(np.diff(beats)))
    avg = avg if avg > 0 else 0.5
    if beat_pos < 0:
        return float(beats[0] + beat_pos * avg)
    if beat_pos > idx[-1]:
        return float(beats[-1] + (beat_pos - idx[-1]) * avg)
    return float(np.interp(beat_pos, idx, beats))


def _snap_grid(x: float, divisors: tuple[int, ...] = (4, 3)) -> float:
    """Snap a quarter-length value to the closest 1/d grid among divisors."""
    best, best_err = x, None
    for d in divisors:
        snapped = round(x * d) / d
        err = abs(snapped - x)
        if best_err is None or err < best_err:
            best, best_err = snapped, err
    return best


def _snap_duration(x: float, divisors: tuple[int, ...] = (4, 3)) -> float:
    s = _snap_grid(x, divisors)
    if s <= 1e-9:
        s = min(1.0 / d for d in divisors)
    return s


def _merge_nearby(events: list[NoteEvent], gap_q: float) -> list[NoteEvent]:
    """Merge same-pitch events whose gap ≤ gap_q (quantize.py:292-328)."""
    by_pitch: dict[int, list[NoteEvent]] = {}
    for ev in events:
        by_pitch.setdefault(int(ev.pitch_midi), []).append(ev)
    merged: list[NoteEvent] = []
    for pitch, evs in by_pitch.items():
        evs.sort(key=lambda e: e.start_time_s)
        cur = None
        for ev in evs:
            if cur is None:
                cur = ev
            elif ev.start_time_s - cur.end_time_s <= max(0.0, gap_q):
                cur = NoteEvent(
                    start_time_s=cur.start_time_s,
                    end_time_s=max(cur.end_time_s, ev.end_time_s),
                    pitch_midi=pitch,
                    velocity=max(cur.velocity, ev.velocity),
                    amplitude=max(cur.amplitude, ev.amplitude),
                )
            else:
                merged.append(cur)
                cur = ev
        if cur is not None:
            merged.append(cur)
    return sorted(merged, key=lambda e: e.start_time_s)


def _chordify(quantized: list[tuple[float, float, int]]) -> list[tuple[list[int], float]]:
    """Boundary sweep: overlapping notes → (pitch set, duration) runs.

    Equivalent to music21 chordify over the quantized part
    (quantize.py:331-379): at every onset/offset boundary the sounding pitch
    set may change; leading/internal silences become rests ([]).
    """
    if not quantized:
        return []
    bounds = sorted({0.0} | {s for s, _, _ in quantized} | {e for _, e, _ in quantized})
    seq: list[tuple[list[int], float]] = []
    eps = 1e-6
    for a, b in zip(bounds, bounds[1:]):
        if b - a <= eps:
            continue
        sounding = sorted({p for s, e, p in quantized if s <= a + eps and e >= b - eps})
        seq.append((sounding, b - a))
    # merge identical neighbors
    merged: list[tuple[list[int], float]] = []
    for pitches, ql in seq:
        if merged and merged[-1][0] == pitches:
            merged[-1] = (pitches, merged[-1][1] + ql)
        else:
            merged.append((pitches, ql))
    return merged


@dataclass(frozen=True)
class QuantizeResult:
    score: ScoreData
    key_signature: KeySignature | None
    pickup_quarters: float = 0.0
    tab_positions: list[list[list[tuple[int, int]]]] | None = None


def quantize_note_events_to_score(
    note_events: list[NoteEvent],
    *,
    tempo_bpm: float,
    beat_times: np.ndarray | None = None,
    time_signature: str = "4/4",
    min_grid_q: float = 0.25,
    snap_to_grid: bool = True,
    merge_gap_s: float = 0.02,
    guitar_tuning: str = "standard",
    with_tab: bool = True,
) -> QuantizeResult:
    key_est = estimate_key_from_events(note_events)
    key_sig = key_est.to_schema() if key_est else None
    use_flats = bool(key_sig.use_flats) if key_sig else False

    num, den = parse_time_signature(time_signature)
    measure_q = num * 4.0 / den

    if not note_events:
        items = [
            ScoreItem(rest=True, keys=[], duration=t.duration, dots=t.dots)
            for t in decompose_duration(measure_q)
        ]
        score = ScoreData(grid_q=1.0, grid_kind="straight", measures=[ScoreMeasure(number=1, items=items)])
        return QuantizeResult(score=score, key_signature=key_sig)

    # 1. warp to quarter-note space
    starts = np.array([e.start_time_s for e in note_events])
    ends = np.array([e.end_time_s for e in note_events])
    if beat_times is not None and len(beat_times) > 1:
        wstarts = to_beats(starts, beat_times)
        wends = to_beats(ends, beat_times)
        sec_per_q = 1.0
    else:
        tempo = tempo_bpm if tempo_bpm and tempo_bpm > 0 else 120.0
        sec_per_q = 60.0 / tempo
        wstarts, wends = starts / sec_per_q, ends / sec_per_q

    # snap the pickup to the 1/12 grid (LCM of the 1/4 and 1/3 grids) so
    # the first measure's remaining length decomposes exactly into tokens
    pickup_quarters = max(0.0, -float(wstarts.min()))
    pickup_quarters = round(pickup_quarters * 12.0) / 12.0
    wstarts += pickup_quarters
    wends += pickup_quarters

    warped = [
        NoteEvent(float(s), float(e), int(ev.pitch_midi), int(ev.velocity), float(ev.amplitude))
        for s, e, ev in zip(wstarts, wends, note_events)
        if e > s
    ]

    # 2. per-pitch gap merge
    gap_q = merge_gap_s if (beat_times is not None and len(beat_times) > 1) else merge_gap_s / sec_per_q
    warped = _merge_nearby(warped, gap_q)

    # 3. grid snap (music21 quantize((4,3)) behavior)
    quantized: list[tuple[float, float, int]] = []
    for ev in warped:
        if snap_to_grid:
            s = _snap_grid(ev.start_time_s)
            d = _snap_duration(ev.end_time_s - ev.start_time_s)
        else:
            s, d = ev.start_time_s, ev.end_time_s - ev.start_time_s
        quantized.append((s, s + d, ev.pitch_midi))

    # 4. chordify sweep
    events_seq = _chordify(quantized)

    # 5. measure packing with ties
    remaining_q = pickup_quarters if pickup_quarters > 1e-6 else measure_q
    measures: list[ScoreMeasure] = []
    current_items: list[ScoreItem] = []
    measure_number = 1
    min_token_q: float | None = None
    has_tuplet = False
    has_straight = False

    def flush_measure():
        nonlocal current_items, measure_number
        measures.append(ScoreMeasure(number=measure_number, items=current_items))
        current_items = []
        measure_number += 1

    for pitches, dur_q in events_seq:
        remaining_event = float(dur_q)
        if remaining_event <= 1e-6:
            continue
        is_pitched = len(pitches) > 0
        event_started = False
        while remaining_event > 1e-6:
            take = min(remaining_event, remaining_q)
            tokens = decompose_duration(take)
            for tidx, token in enumerate(tokens):
                is_first = (not event_started) and tidx == 0
                is_last = (remaining_event - take <= 1e-6) and tidx == len(tokens) - 1
                tie: Optional[str] = None
                if is_pitched and not (is_first and is_last):
                    tie = "start" if is_first else ("stop" if is_last else "continue")
                keys = (
                    [midi_to_vexflow_key(p, use_flats=use_flats) for p in sorted(set(pitches))]
                    if pitches
                    else []
                )
                tuplet_spec = None
                if token.tuplet is not None:
                    tuplet_spec = TupletSpec(num_notes=token.tuplet[0], notes_occupied=token.tuplet[1])
                    has_tuplet = True
                else:
                    has_straight = True
                current_items.append(
                    ScoreItem(
                        rest=not keys,
                        keys=keys,
                        duration=token.duration,
                        dots=token.dots,
                        tuplet=tuplet_spec,
                        tie=tie,  # type: ignore[arg-type]
                    )
                )
                min_token_q = token.ql if min_token_q is None else min(min_token_q, token.ql)
                event_started = True
            remaining_event -= take
            remaining_q -= take
            if remaining_q <= 1e-6:
                flush_measure()
                remaining_q = measure_q
    if current_items:
        flush_measure()

    grid_q = float(min_token_q if min_token_q is not None else 1.0)
    if min_grid_q and min_grid_q > 0:
        grid_q = max(grid_q, min_grid_q)
    grid_kind: Literal["straight", "triplet"] = (
        "triplet" if has_tuplet and not has_straight else "straight"
    )
    score = ScoreData(grid_q=grid_q, grid_kind=grid_kind, measures=measures)

    # 6. DP tab assignment over the pitched items. Callers that only need
    # the notation (the half/double-time beat-grid selection scores
    # readability over 3 candidate grids per song) skip the DP — it is the
    # single most expensive host stage and its result is discarded there.
    tab_positions: list[list[list[tuple[int, int]]]] | None = None
    if not with_tab:
        return QuantizeResult(
            score=score,
            key_signature=key_sig,
            pickup_quarters=pickup_quarters,
            tab_positions=None,
        )
    try:
        tuning = get_tuning(guitar_tuning)
        opt_events: list[tuple[float, list[int], str | None]] = []
        item_refs: list[tuple[int, int]] = []
        tab_positions = []
        offset_q = 0.0
        for m_idx, meas in enumerate(score.measures):
            measure_positions: list[list[tuple[int, int]]] = []
            for item_idx, item in enumerate(meas.items):
                dq = duration_to_quarters(item)
                if not item.rest and item.keys:
                    pitches = [m for m in (vexflow_key_to_midi(k) for k in item.keys) if m is not None]
                    if pitches:
                        t_q = offset_q - pickup_quarters
                        t_sec = beats_to_seconds(t_q, beat_times, tempo_bpm)
                        opt_events.append((t_sec, pitches, None))
                        item_refs.append((m_idx, item_idx))
                measure_positions.append([])
                offset_q += dq
            tab_positions.append(measure_positions)

        if opt_events:
            opt = optimize_tab_positions_for_events(opt_events, tuning=tuning, tempo_bpm=tempo_bpm)
            for ev_idx, (m_idx, item_idx) in enumerate(item_refs):
                if ev_idx >= len(opt.events):
                    break
                positions = [(p.string, p.fret) for p in opt.events[ev_idx].positions]
                if positions and len(positions) == len(score.measures[m_idx].items[item_idx].keys):
                    tab_positions[m_idx][item_idx] = positions
    except Exception:
        tab_positions = None

    return QuantizeResult(
        score=score,
        key_signature=key_sig,
        pickup_quarters=pickup_quarters,
        tab_positions=tab_positions,
    )
