"""Transcription modes: guitar (hybrid), accompaniment (slash), notes.

Capability parity with the reference's mode machinery (reference: backend/
app/services/pipeline.py:219-430 strum events + grid quantization,
:1307-1533 guitar mode + merge).

The port's copy of ``audiotabs_tpu/runtime/modes.py``: host code, arithmetic
unchanged. Notes mode is ``theory/postprocess.py``. ``run_guitar_mode``
classifies content from the fused analysis' window metrics, or computes them
on ``device`` for other window settings; without the pipeline's base note
events it transcribes the signal itself on ``device`` (Basic Pitch, then the
pYIN melody if that fails), as the JAX package does.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass, field

import numpy as np

from ..accompaniment.shapes import Shape, pick_shape_for_chord, shape_pitches, shape_positions
from ..accompaniment.strum import card_fluxes, detect_strum_onsets
from ..analysis.content_classifier import ContentSegment, analyze_musical_content
from ..schemas import ChordSegment, ScoreData, ScoreItem, ScoreMeasure
from ..theory.events import NoteEvent
from ..theory.quantize import (
    DUR_TOKENS_STRAIGHT,
    midi_to_vexflow_key,
    parse_time_signature,
    to_beats,
)

_LOG = logging.getLogger(__name__)


@dataclass(frozen=True)
class StrumEvent:
    time_s: float
    keys: list[str]
    positions: list[tuple[int, int]]
    pitches: list[int]


@dataclass
class ModeResult:
    note_events: list[NoteEvent] = field(default_factory=list)
    backend: str = "none"
    score_override: ScoreData | None = None
    pickup_quarters: float = 0.0
    tab_positions: list | None = None
    strum_onsets: list[float] = field(default_factory=list)
    chosen_shapes: list[dict] = field(default_factory=list)
    content_segments: list[ContentSegment] = field(default_factory=list)


def assign_shapes(chords: list[ChordSegment]) -> list[tuple[ChordSegment, Shape | None]]:
    """Pick a playable shape per chord segment with movement continuity."""
    out: list[tuple[ChordSegment, Shape | None]] = []
    prev: Shape | None = None
    for seg in sorted(chords, key=lambda c: c.start):
        shape = pick_shape_for_chord(seg.label, prev)
        out.append((seg, shape))
        if shape is not None:
            prev = shape
    return out


def build_strum_events(
    onsets_s: np.ndarray,
    segments: list[tuple[ChordSegment, Shape | None]],
    *,
    use_flats: bool,
) -> list[StrumEvent]:
    events: list[StrumEvent] = []
    for t in np.sort(np.asarray(onsets_s, dtype=np.float64)):
        shape = None
        for seg, s in segments:
            if seg.start <= t < seg.end:
                shape = s
                break
        if shape is None:
            events.append(StrumEvent(float(t), [], [], []))
            continue
        pitches = shape_pitches(shape)
        events.append(
            StrumEvent(
                float(t),
                [midi_to_vexflow_key(p, use_flats=use_flats) for p in pitches],
                shape_positions(shape),
                pitches,
            )
        )
    return events


def strum_events_to_note_events(events: list[StrumEvent], *, tempo_bpm: float) -> list[NoteEvent]:
    sec_per_q = 60.0 / (tempo_bpm if tempo_bpm and tempo_bpm > 0 else 120.0)
    dur = max(0.08, 0.2 * sec_per_q)
    return [
        NoteEvent(ev.time_s, ev.time_s + dur, p, 90, 1.0) for ev in events for p in ev.pitches
    ]


def _decompose_straight(duration_q: float):
    out = []
    rem = float(duration_q)
    for tok in DUR_TOKENS_STRAIGHT:
        while rem + 1e-6 >= tok.ql:
            out.append((tok.duration, tok.dots, tok.ql))
            rem -= tok.ql
    if rem > 1e-3:
        out.append((DUR_TOKENS_STRAIGHT[-1].duration, DUR_TOKENS_STRAIGHT[-1].dots, DUR_TOKENS_STRAIGHT[-1].ql))
    return out


def _choose_strum_grid(positions: np.ndarray) -> float:
    best = None
    for grid, penalty in ((0.25, 1.1), (0.5, 1.0), (1.0, 1.05)):
        q = np.round(positions / grid) * grid
        cost = float(np.mean(np.abs(positions - q))) * penalty
        if best is None or cost < best[0]:
            best = (cost, grid)
    return best[1] if best else 0.5


def _empty_measure(time_signature: str, grid_q: float):
    num, den = parse_time_signature(time_signature)
    measure_q = num * 4.0 / den
    items = [ScoreItem(rest=True, keys=[], duration=d, dots=dots) for d, dots, _ in _decompose_straight(measure_q)]
    positions = [[] for _ in items]
    return (
        ScoreData(grid_q=grid_q, grid_kind="straight", measures=[ScoreMeasure(number=1, items=items)]),
        0.0,
        [positions],
    )


def quantize_strum_events(
    events: list[StrumEvent],
    *,
    beat_times: np.ndarray | None,
    tempo_bpm: float,
    time_signature: str = "4/4",
    min_grid_q: float = 0.25,
) -> tuple[ScoreData, float, list]:
    """Strum events → slash-notation ScoreData on the best beat subdivision
    (reference: pipeline.py:265-430)."""
    if not events:
        return _empty_measure(time_signature, 1.0)

    times = np.asarray([e.time_s for e in events], dtype=np.float64)
    if beat_times is not None and len(beat_times) > 1:
        positions = to_beats(times, np.asarray(beat_times, dtype=np.float64))
    else:
        sec_per_q = 60.0 / (tempo_bpm if tempo_bpm and tempo_bpm > 0 else 120.0)
        positions = times / sec_per_q

    grid_q = max(_choose_strum_grid(positions), min_grid_q)
    steps = np.round(positions / grid_q).astype(int)
    step_map: dict[int, StrumEvent] = {}
    for step, ev in zip(steps, events):
        prev = step_map.get(int(step))
        if prev is None or len(ev.keys) > len(prev.keys):
            step_map[int(step)] = ev
    steps_sorted = sorted(step_map)
    if not steps_sorted:
        return _empty_measure(time_signature, grid_q)

    min_step = min(0, steps_sorted[0])
    default_steps = max(1, int(round(1.0 / grid_q)))

    timeline: list[tuple[list[str], list[tuple[int, int]], int]] = []
    if steps_sorted[0] > min_step:
        timeline.append(([], [], steps_sorted[0] - min_step))
    for i, step in enumerate(steps_sorted):
        ev = step_map[step]
        nxt = steps_sorted[i + 1] if i + 1 < len(steps_sorted) else step + default_steps
        timeline.append((list(ev.keys), list(ev.positions), max(1, nxt - step)))

    num, den = parse_time_signature(time_signature)
    measure_q = num * 4.0 / den
    steps_per_measure = max(1, int(round(measure_q / grid_q)))
    pickup_steps = max(0, -min_step) % steps_per_measure
    pickup_quarters = pickup_steps * grid_q

    measures: list[ScoreMeasure] = []
    tab_positions: list = []
    cur_items: list[ScoreItem] = []
    cur_pos: list = []
    measure_number = 1
    remaining = pickup_steps if pickup_steps > 0 else steps_per_measure

    def flush():
        nonlocal cur_items, cur_pos, measure_number
        measures.append(ScoreMeasure(number=measure_number, items=cur_items))
        tab_positions.append(cur_pos)
        cur_items, cur_pos = [], []
        measure_number += 1

    for keys, positions_i, dur_steps in timeline:
        # pre-count total items for tie labeling
        item_total = 0
        if keys:
            rem, left = remaining, dur_steps
            while left > 0:
                take = min(left, rem)
                item_total += len(_decompose_straight(take * grid_q))
                left -= take
                rem -= take
                if rem <= 0:
                    rem = steps_per_measure
        left = dur_steps
        item_idx = 0
        while left > 0:
            take = min(left, remaining)
            for d, dots, _ in _decompose_straight(take * grid_q):
                item_idx += 1
                tie = None
                if keys and item_total > 1:
                    tie = "start" if item_idx == 1 else ("stop" if item_idx == item_total else "continue")
                cur_items.append(ScoreItem(rest=not keys, keys=list(keys), duration=d, dots=dots, tie=tie))
                cur_pos.append(list(positions_i) if keys else [])
            left -= take
            remaining -= take
            if remaining <= 0:
                flush()
                remaining = steps_per_measure
    if cur_items:
        flush()

    return ScoreData(grid_q=grid_q, grid_kind="straight", measures=measures), pickup_quarters, tab_positions


def run_accompaniment_mode(
    y: np.ndarray,
    sr: int,
    chords: list[ChordSegment],
    beat_times: np.ndarray | None,
    tempo_bpm: float,
    *,
    use_flats: bool = False,
    time_signature: str = "4/4",
    strum_envelope: np.ndarray | None = None,
    device=None,
) -> ModeResult:
    """Strum onsets + chord shapes → slash score (pipeline.py:1884-1909).
    Without ``strum_envelope``, the whole song's envelope is computed on
    ``device`` where it is a CUDA device (``accompaniment/strum.py``)."""
    flux = card_fluxes(y, sr, [(0, len(y))], device)[0] if strum_envelope is None else None
    onsets = detect_strum_onsets(
        y, sr, beat_times=beat_times if beat_times is not None and len(beat_times) > 1 else None,
        tempo_bpm=tempo_bpm, envelope=strum_envelope, flux=flux,
    )
    segments = assign_shapes(chords)
    events = build_strum_events(onsets, segments, use_flats=use_flats)
    score, pickup, tab_positions = quantize_strum_events(
        events, beat_times=beat_times, tempo_bpm=tempo_bpm, time_signature=time_signature,
        min_grid_q=0.5,  # the reference's accompaniment floor (_ACC_MIN_GRID_Q)
    )
    from ..accompaniment.shapes import shape_to_dict

    return ModeResult(
        note_events=strum_events_to_note_events(events, tempo_bpm=tempo_bpm),
        backend="accompaniment+chords_viterbi",
        score_override=score,
        pickup_quarters=pickup,
        tab_positions=tab_positions,
        strum_onsets=[float(t) for t in onsets],
        chosen_shapes=[shape_to_dict(s) for _seg, s in segments if s is not None],
    )


def run_guitar_mode(
    y: np.ndarray,
    sr: int,
    chords: list[ChordSegment],
    beat_times: np.ndarray | None,
    tempo_bpm: float,
    *,
    base_note_events: list[NoteEvent] | None = None,
    use_flats: bool = False,
    window_sec: float = 3.0,
    hop_sec: float = 1.5,
    precomputed_content: tuple | None = None,
    strum_envelope: np.ndarray | None = None,
    y_strum: tuple[np.ndarray, int] | None = None,
    device=None,
) -> ModeResult:
    """Hybrid mode: content classification routes each section to melodic
    transcription or strum detection (pipeline.py:1307-1533). Pass
    ``y_strum`` = (native_audio, native_sr) to detect strums from the
    full-band signal (the >11 kHz pick transients shape the median-mel
    envelope — accompaniment/strum.py); otherwise the 22.05 kHz
    ``strum_envelope`` slices are used. Segments without a slice have their
    envelopes computed in one pass on ``device`` where it is a CUDA device."""
    content = analyze_musical_content(
        y, sr, window_sec=window_sec, hop_sec=hop_sec, precomputed=precomputed_content, device=device
    )

    if base_note_events is None:
        try:
            from ..models.basicpitch import transcribe_polyphonic

            base_note_events = transcribe_polyphonic(y, sr, device=device)
        except Exception:
            from ..decode.melody import transcribe_melody

            base_note_events = transcribe_melody(y, sr, device=device)

    segment_shapes = assign_shapes(chords)
    note_events: list[NoteEvent] = []
    strum_events: list[StrumEvent] = []
    all_onsets: list[float] = []

    # the chordal and hybrid segments' samples [lo, hi) of the strum signal
    y_src, sr_seg = y_strum if y_strum is not None else (y, sr)
    strum_bounds: dict[int, tuple[int, int]] = {}
    for i, seg in enumerate(content):
        if seg.content_type in ("chordal", "hybrid"):
            lo, hi, _ = slice(int(seg.start_time_s * sr_seg), int(seg.end_time_s * sr_seg)).indices(len(y_src))
            if hi - lo > sr_seg * 0.2:
                strum_bounds[i] = (lo, hi)
    fluxes = {}
    if y_strum is not None or strum_envelope is None:
        fluxes = dict(zip(strum_bounds, card_fluxes(y_src, sr_seg, list(strum_bounds.values()), device)))

    for i, seg in enumerate(content):
        a, b = seg.start_time_s, seg.end_time_s
        if seg.content_type in ("melodic", "hybrid"):
            note_events.extend(n for n in base_note_events if a <= n.start_time_s < b)
        if i in strum_bounds:
            lo, hi = strum_bounds[i]
            y_seg = y_src[lo:hi]
            bt_seg = None
            if beat_times is not None and len(beat_times) > 1:
                bt = np.asarray(beat_times)
                m = (bt >= a) & (bt < b)
                if np.count_nonzero(m) >= 2:
                    bt_seg = bt[m] - a
            try:
                env_seg = None
                if y_strum is None and strum_envelope is not None:
                    env_seg = strum_envelope[int(a * sr) // 512 : int(b * sr) // 512 + 1]
                onsets = detect_strum_onsets(
                    y_seg,
                    sr_seg,
                    beat_times=bt_seg,
                    tempo_bpm=tempo_bpm,
                    min_interval_s=0.12 if seg.content_type == "chordal" else 0.2,
                    onset_delta=0.2 if seg.content_type == "chordal" else 0.25,
                    envelope=env_seg,
                    flux=fluxes.get(i),
                )
                onsets = onsets + a
                all_onsets.extend(float(t) for t in onsets)
                strum_events.extend(build_strum_events(onsets, segment_shapes, use_flats=use_flats))
            except Exception as exc:
                _LOG.warning("strum detection failed for %.1f-%.1f: %s", a, b, exc)

    # merge with dedup (pipeline.py:1420-1480)
    def ctype_at(t: float) -> str:
        for s in content:
            if s.start_time_s <= t < s.end_time_s:
                return s.content_type
        return "hybrid"

    merged = [n for n in note_events if ctype_at(n.start_time_s) in ("melodic", "hybrid")]
    for note in strum_events_to_note_events(strum_events, tempo_bpm=tempo_bpm):
        ct = ctype_at(note.start_time_s)
        if ct == "chordal":
            merged.append(note)
        elif ct == "hybrid":
            dup = any(
                abs(e.start_time_s - note.start_time_s) < 0.05 and e.pitch_midi == note.pitch_midi
                for e in merged
            )
            if not dup:
                merged.append(note)
    merged.sort(key=lambda n: n.start_time_s)

    from ..accompaniment.shapes import shape_to_dict

    return ModeResult(
        note_events=merged,
        backend="guitar_hybrid",
        strum_onsets=all_onsets,
        chosen_shapes=[shape_to_dict(s) for _seg, s in segment_shapes if s is not None],
        content_segments=content,
    )
