"""Musical post-processing of note events: harmonics, clusters, theory rules.

The port's copy of audiotabs_tpu/theory/postprocess.py (host numpy,
arithmetic unchanged); ``postprocess_note_events`` takes the port's
``Settings``, as there is no module-global one.

Capability parity with the reference's postprocessor (reference: backend/
app/services/theory/musical_postprocessor.py:16-437), re-expressed with
vectorized pairwise numpy inside onset groups:

  * remove_harmonic_duplicates — drop the upper note of octave/5th/4th/3rd
    pairs when its amplitude is below a kind-dependent fraction of the
    fundamental's (even 0.7 / odd 0.55, ±50 cents, 100 ms onset windows,
    processed in 30 s chunks).
  * merge_temporal_clusters — fuse re-detections of the same (±1 semitone)
    pitch within an 80 ms window / 50 ms gap, keeping the max-amplitude
    member's pitch/velocity and the union span.
  * apply_music_theory_rules — greedy voice assignment (jump + range
    costs), semitone-clash dissonance resolution with credibility =
    0.5·amplitude + 0.3·chord-tone + 0.2·melodic, then a voice-range
    outlier sweep.

Plus the pipeline-level filters (reference: services/pipeline.py:541-728):
amplitude/duration/range filters, overlap merge, and a polyphony cap.
"""

from __future__ import annotations

import logging
import math

import numpy as np

from ..schemas import ChordSegment
from .events import NoteEvent
from .vocabulary import chord_tone_pcs

_LOG = logging.getLogger(__name__)

_HARMONIC_RATIOS = ((2.0, "even"), (1.5, "odd"), (4.0 / 3.0, "odd"), (1.25, "odd"))
_CHUNK_SEC = 30.0


def _group_spans(starts: np.ndarray, window_s: float) -> list[tuple[int, int]]:
    """Split sorted onset times into windows anchored at each group's first onset."""
    spans = []
    i, n = 0, len(starts)
    while i < n:
        j = i + 1
        while j < n and starts[j] - starts[i] <= window_s:
            j += 1
        spans.append((i, j))
        i = j
    return spans


def remove_harmonic_duplicates(
    note_events: list[NoteEvent],
    *,
    window_ms: float = 100.0,
    tolerance_cents: float = 50.0,
    even_threshold: float = 0.7,
    odd_threshold: float = 0.55,
) -> list[NoteEvent]:
    if not note_events:
        return []
    events = sorted(note_events, key=lambda e: e.start_time_s)
    starts = np.array([e.start_time_s for e in events])
    pitches = np.array([e.pitch_midi for e in events], dtype=np.float64)
    amps = np.array([e.amplitude for e in events], dtype=np.float64)
    freqs = 440.0 * 2.0 ** ((pitches - 69.0) / 12.0)

    keep = np.ones(len(events), dtype=bool)
    removed = 0
    # 30 s chunks then onset windows, as in the reference
    chunk_edges = _group_spans(starts, _CHUNK_SEC)
    for ca, cb in chunk_edges:
        for a, b in _group_spans(starts[ca:cb], window_ms / 1000.0):
            lo, hi = ca + a, ca + b
            m = hi - lo
            if m < 2:
                continue
            f = freqs[lo:hi]
            am = amps[lo:hi]
            # pairwise ratio high/low
            ratio = np.maximum(f[:, None], f[None, :]) / np.maximum(
                np.minimum(f[:, None], f[None, :]), 1e-9
            )
            cents = 1200.0 * np.log2(ratio[:, :, None] / np.array([r for r, _ in _HARMONIC_RATIOS]))
            match = np.abs(cents) <= tolerance_cents  # [m, m, 4]
            thresholds = np.array(
                [even_threshold if k == "even" else odd_threshold for _, k in _HARMONIC_RATIOS]
            )
            # first matching ratio per pair
            first = np.argmax(match, axis=2)
            any_match = match.any(axis=2)
            thr = thresholds[first]
            upper = np.triu(np.ones((m, m), dtype=bool), 1)
            for i, j in zip(*np.nonzero(any_match & upper)):
                gi, gj = lo + i, lo + j
                if not (keep[gi] and keep[gj]):
                    continue
                hi_idx, lo_idx = (gi, gj) if f[i] > f[j] else (gj, gi)
                if amps[hi_idx] < amps[lo_idx] * thr[i, j]:
                    keep[hi_idx] = False
                    removed += 1

    _LOG.info("Removed %d harmonic duplicates", removed)
    return [e for e, k in zip(events, keep) if k]


def merge_temporal_clusters(
    note_events: list[NoteEvent],
    window_ms: float = 80.0,
    gap_ms: float = 50.0,
) -> list[NoteEvent]:
    if not note_events:
        return []
    window_s, gap_s = window_ms / 1000.0, gap_ms / 1000.0
    events = sorted(note_events, key=lambda e: e.start_time_s)

    groups: list[dict] = []
    last_by_pitch: dict[int, int] = {}
    merged = 0
    for ev in events:
        pitch = ev.pitch_midi
        best_idx, best_score = None, None
        for p in (pitch - 1, pitch, pitch + 1):
            idx = last_by_pitch.get(p)
            if idx is None:
                continue
            g = groups[idx]
            if abs(pitch - g["pitch"]) > 1:
                continue
            if ev.start_time_s - g["start"] > window_s:
                continue
            if ev.start_time_s - g["end"] > gap_s:
                continue
            score = abs(pitch - g["pitch"]) + abs(ev.start_time_s - g["end"])
            if best_score is None or score < best_score:
                best_score, best_idx = score, idx
        if best_idx is None:
            groups.append(
                {"start": ev.start_time_s, "end": ev.end_time_s, "pitch": pitch,
                 "amp": ev.amplitude, "vel": ev.velocity}
            )
            last_by_pitch[pitch] = len(groups) - 1
        else:
            g = groups[best_idx]
            g["end"] = max(g["end"], ev.end_time_s)
            if ev.amplitude >= g["amp"]:
                g["amp"], g["vel"], g["pitch"] = ev.amplitude, ev.velocity, pitch
            last_by_pitch[pitch] = best_idx
            merged += 1

    _LOG.info("Merged %d temporal clusters", merged)
    return sorted(
        (
            NoteEvent(g["start"], g["end"], g["pitch"], g["vel"], g["amp"])
            for g in groups
        ),
        key=lambda e: e.start_time_s,
    )


def _assign_voices(events: list[NoteEvent], onset_window_s: float) -> dict[int, list[int]]:
    """Greedy voice assignment with jump/range costs
    (reference: musical_postprocessor.py:258-323)."""
    starts = np.array([e.start_time_s for e in events])
    voices: list[dict] = []
    for a, b in _group_spans(starts, onset_window_s):
        members = sorted(range(a, b), key=lambda i: events[i].pitch_midi)
        if not voices:
            for idx in members:
                p = events[idx].pitch_midi
                voices.append({"last": p, "min": p, "max": p, "idx": [idx]})
            continue
        used: set[int] = set()
        assignments = []
        for idx in members:
            pitch = events[idx].pitch_midi
            best, best_cost = None, None
            for v_i, v in enumerate(voices):
                if v_i in used:
                    continue
                jump = abs(pitch - v["last"])
                cost = float(jump)
                if jump > 7:
                    cost += math.exp((jump - 7) / 5.0)
                if max(v["max"], pitch) - min(v["min"], pitch) > 24:
                    cost += 4.0
                if best_cost is None or cost < best_cost:
                    best_cost, best = cost, v_i
            if best is None:
                p = events[idx].pitch_midi
                # idx is appended by the assignments loop below; the new
                # voice is marked used so a later note in this same onset
                # group can't also land on it
                voices.append({"last": p, "min": p, "max": p, "idx": []})
                best = len(voices) - 1
            used.add(best)
            assignments.append((best, idx))
        for v_i, idx in assignments:
            v = voices[v_i]
            p = events[idx].pitch_midi
            v["last"], v["min"], v["max"] = p, min(v["min"], p), max(v["max"], p)
            v["idx"].append(idx)
        voices.sort(key=lambda v: v["last"])
    return {
        i: sorted(v["idx"], key=lambda idx: events[idx].start_time_s)
        for i, v in enumerate(voices)
    }


def _chord_label_at(chords: list[ChordSegment], t: float) -> str | None:
    for seg in chords:
        if seg.start <= t < seg.end:
            return seg.label
    return None


def apply_music_theory_rules(
    note_events: list[NoteEvent],
    chords: list[ChordSegment],
    key_sig=None,
    *,
    dissonance_window_ms: float = 60.0,
    aggressiveness: float = 0.5,
    voice_window_ms: float = 60.0,
) -> list[NoteEvent]:
    del key_sig
    if not note_events:
        return []
    aggressiveness = min(1.0, max(0.0, aggressiveness))
    events = sorted(note_events, key=lambda e: e.start_time_s)
    starts = np.array([e.start_time_s for e in events])

    voices = _assign_voices(events, voice_window_ms / 1000.0)
    prev_pitch: dict[int, int] = {}
    for indices in voices.values():
        for i in range(1, len(indices)):
            prev_pitch[indices[i]] = events[indices[i - 1]].pitch_midi

    def melodic_score(pitch: int, prev: int | None) -> float:
        if prev is None:
            return 0.6
        jump = abs(pitch - prev)
        if jump > 12:
            return 0.2
        return max(0.2, 1.0 - jump / 12.0 * 0.6)

    remove: set[int] = set()
    removed_diss = 0
    for a, b in _group_spans(starts, dissonance_window_ms / 1000.0):
        group = list(range(a, b))
        if len(group) < 2:
            continue
        pitches = [events[i].pitch_midi for i in group]
        amps = [events[i].amplitude for i in group]
        avg_amp = float(np.mean(amps))
        if len(pitches) >= 3 and max(pitches) - min(pitches) <= 2:
            continue  # dense tone cluster: likely intentional
        label = _chord_label_at(chords, events[group[0]].start_time_s)
        pcs = chord_tone_pcs(label) if label else None

        def credibility(idx: int) -> float:
            amp = events[idx].amplitude
            amp_score = min(1.0, amp / (avg_amp + 1e-6)) if avg_amp > 0 else 0.5
            pitch = events[idx].pitch_midi
            chord_score = 0.6
            if pcs is not None:
                chord_score = 1.0 if (pitch % 12) in pcs else 0.2
            return 0.5 * amp_score + 0.3 * chord_score + 0.2 * melodic_score(pitch, prev_pitch.get(idx))

        for x, i in enumerate(group):
            if i in remove:
                continue
            for j in group[x + 1 :]:
                if j in remove:
                    continue
                if abs(events[i].pitch_midi - events[j].pitch_midi) % 12 != 1:
                    continue
                si, sj = credibility(i), credibility(j)
                if si == sj:
                    continue
                low = j if si > sj else i
                if abs(si - sj) >= 0.2 - 0.1 * aggressiveness:
                    remove.add(low)
                    removed_diss += 1

    filtered = [e for i, e in enumerate(events) if i not in remove]

    # voice-range outlier sweep
    voices = _assign_voices(filtered, voice_window_ms / 1000.0)
    removed_outliers = 0
    to_remove: set[int] = set()
    for indices in voices.values():
        pitches = [filtered[i].pitch_midi for i in indices]
        if not pitches or max(pitches) - min(pitches) <= 24:
            continue
        median_pitch = float(np.median(pitches))
        avg_amp = float(np.mean([filtered[i].amplitude for i in indices]))
        for i in indices:
            if abs(filtered[i].pitch_midi - median_pitch) > 12 and filtered[i].amplitude < avg_amp * 0.4:
                to_remove.add(i)
                removed_outliers += 1

    _LOG.info(
        "theory rules: removed %d dissonances, %d outliers", removed_diss, removed_outliers
    )
    return [e for i, e in enumerate(filtered) if i not in to_remove]


# ---- pipeline-level event filters (reference: pipeline.py:541-728) ----


def merge_overlapping_same_pitch(events: list[NoteEvent]) -> list[NoteEvent]:
    by_pitch: dict[int, list[NoteEvent]] = {}
    for e in events:
        by_pitch.setdefault(e.pitch_midi, []).append(e)
    out = []
    for pitch, evs in by_pitch.items():
        evs.sort(key=lambda e: e.start_time_s)
        cur = evs[0]
        for e in evs[1:]:
            if e.start_time_s <= cur.end_time_s:
                cur = NoteEvent(
                    cur.start_time_s,
                    max(cur.end_time_s, e.end_time_s),
                    pitch,
                    max(cur.velocity, e.velocity),
                    max(cur.amplitude, e.amplitude),
                )
            else:
                out.append(cur)
                cur = e
        out.append(cur)
    return sorted(out, key=lambda e: e.start_time_s)


def filter_note_events(
    events: list[NoteEvent],
    *,
    min_amplitude: float = 0.0,
    min_duration_s: float = 0.03,
    pitch_range: tuple[int, int] = (28, 96),
    max_polyphony: int = 6,
    onset_window_s: float = 0.05,
) -> list[NoteEvent]:
    """Amplitude/duration/range filters + polyphony cap (keep the loudest)."""
    kept = [
        e
        for e in events
        if e.amplitude >= min_amplitude
        and (e.end_time_s - e.start_time_s) >= min_duration_s
        and pitch_range[0] <= e.pitch_midi <= pitch_range[1]
    ]
    kept.sort(key=lambda e: e.start_time_s)
    if max_polyphony <= 0:
        return kept
    starts = np.array([e.start_time_s for e in kept])
    out: list[NoteEvent] = []
    for a, b in _group_spans(starts, onset_window_s):
        group = kept[a:b]
        if len(group) > max_polyphony:
            group = sorted(group, key=lambda e: -e.amplitude)[:max_polyphony]
            group.sort(key=lambda e: e.start_time_s)
        out.extend(group)
    return out


def postprocess_note_events(
    events: list[NoteEvent],
    chords: list[ChordSegment],
    key_sig=None,
    *,
    settings,
) -> list[NoteEvent]:
    """The full notes-mode chain (reference: pipeline.py:1870-1875 →
    musical_postprocessor stages → filters → polyphony cap → theory rules),
    with the thresholds of ``settings`` (config.py::Settings)."""
    events = remove_harmonic_duplicates(
        events,
        window_ms=settings.HARMONIC_DUPLICATE_WINDOW_MS,
        tolerance_cents=settings.HARMONIC_TOLERANCE_CENTS,
        even_threshold=settings.HARMONIC_EVEN_THRESHOLD,
        odd_threshold=settings.HARMONIC_ODD_THRESHOLD,
    )
    events = merge_temporal_clusters(
        events,
        window_ms=settings.TEMPORAL_CLUSTER_WINDOW_MS,
        gap_ms=settings.TEMPORAL_CLUSTER_GAP_MS,
    )
    events = merge_overlapping_same_pitch(events)
    events = filter_note_events(events)
    events = apply_music_theory_rules(
        events,
        chords,
        key_sig,
        dissonance_window_ms=settings.DISSONANCE_WINDOW_MS,
        aggressiveness=settings.DISSONANCE_CORRECTION_AGGRESSIVENESS,
        voice_window_ms=settings.VOICE_ASSIGN_WINDOW_MS,
    )
    return events
