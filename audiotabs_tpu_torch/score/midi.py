"""Standard MIDI File writer (no external MIDI library).

Replaces the reference's music21 MIDI writes (reference: backend/app/
services/musicxml/export.py:400-403, services/midi/export.py:65-161) with a
raw SMF type-1 serializer: a tempo track plus one note track.

The port's copy of ``audiotabs_tpu/score/midi.py``: host code, arithmetic unchanged.
"""

from __future__ import annotations

import struct

import numpy as np
from pathlib import Path
from typing import Iterable, Sequence

from ..schemas import ScoreData
from ..theory.quantize import duration_to_quarters, vexflow_key_to_midi

PPQ = 480


def _varlen(value: int) -> bytes:
    buf = value & 0x7F
    out = bytearray()
    value >>= 7
    while value:
        buf <<= 8
        buf |= (value & 0x7F) | 0x80
        value >>= 7
    while True:
        out.append(buf & 0xFF)
        if buf & 0x80:
            buf >>= 8
        else:
            break
    return bytes(out)


def _track_chunk(events: list[tuple[int, bytes]]) -> bytes:
    """events: (absolute_tick, event_bytes) → one MTrk chunk."""
    events = sorted(events, key=lambda e: e[0])
    body = bytearray()
    last = 0
    for tick, ev in events:
        body += _varlen(max(0, tick - last))
        body += ev
        last = tick
    body += _varlen(0) + b"\xff\x2f\x00"  # end of track
    return b"MTrk" + struct.pack(">I", len(body)) + bytes(body)


def _header(num_tracks: int) -> bytes:
    return b"MThd" + struct.pack(">IHHH", 6, 1, num_tracks, PPQ)


def _tempo_track(tempo_bpm: float) -> bytes:
    usec_per_q = int(round(60_000_000 / max(1.0, tempo_bpm)))
    ev = b"\xff\x51\x03" + struct.pack(">I", usec_per_q)[1:]
    return _track_chunk([(0, ev)])


def write_midi_notes(
    path: Path | str,
    notes: Iterable[tuple[float, float, int, int]],
    *,
    tempo_bpm: float = 120.0,
    program: int = 25,  # steel-string acoustic guitar
) -> None:
    """notes: (start_q, dur_q, midi pitch, velocity) in quarter-note units."""
    track: list[tuple[int, bytes]] = [(0, bytes([0xC0, program & 0x7F]))]
    for start_q, dur_q, pitch, vel in notes:
        on = int(round(start_q * PPQ))
        off = int(round((start_q + max(dur_q, 1e-3)) * PPQ))
        p = max(0, min(127, int(pitch)))
        v = max(1, min(127, int(vel)))
        track.append((on, bytes([0x90, p, v])))
        track.append((off, bytes([0x80, p, 0])))
    data = _header(2) + _tempo_track(tempo_bpm) + _track_chunk(track)
    Path(path).write_bytes(data)


def write_midi_from_score(path: Path | str, score: ScoreData, *, tempo_bpm: float = 120.0) -> None:
    """Serialize a ScoreData (with ties merged) to MIDI."""
    notes: list[tuple[float, float, int, int]] = []
    open_ties: dict[int, int] = {}  # pitch → note index in `notes`
    offset_q = 0.0
    for meas in score.measures:
        for item in meas.items:
            dq = duration_to_quarters(item)
            if not item.rest and item.keys:
                for key in item.keys:
                    pitch = vexflow_key_to_midi(key)
                    if pitch is None:
                        continue
                    if item.tie in ("stop", "continue") and pitch in open_ties:
                        i = open_ties[pitch]
                        s, d, p, v = notes[i]
                        notes[i] = (s, offset_q + dq - s, p, v)
                        if item.tie == "stop":
                            del open_ties[pitch]
                        continue
                    notes.append((offset_q, dq, pitch, 80))
                    if item.tie == "start":
                        open_ties[pitch] = len(notes) - 1
            offset_q += dq
    write_midi_notes(path, notes, tempo_bpm=tempo_bpm)


def write_midi_from_note_events(
    path: Path | str, note_events, *, tempo_bpm: float = 120.0
) -> None:
    """Serialize raw (seconds-domain) note events to MIDI."""
    sec_per_q = 60.0 / max(1.0, tempo_bpm)
    notes = [
        (
            ev.start_time_s / sec_per_q,
            max(1e-3, (ev.end_time_s - ev.start_time_s)) / sec_per_q,
            ev.pitch_midi,
            ev.velocity,
        )
        for ev in note_events
    ]
    write_midi_notes(path, notes, tempo_bpm=tempo_bpm)


def export_chords_midi(
    path: Path | str,
    chords,
    *,
    tempo_bpm: float = 120.0,
    beat_times: Sequence[float] | None = None,
    per_beat: bool = False,
) -> None:
    """Block-chord MIDI (reference: backend/app/services/midi/export.py:65-161).

    per_beat=False: one sustained voicing per chord segment.
    per_beat=True: the voicing is re-struck at every beat inside the segment
    (requires beat_times), the reference's per-beat comping variant.
    """
    from ..theory.vocabulary import NOTE_TO_PC, QUALITY_INTERVALS, split_chord_label

    sec_per_q = 60.0 / max(1.0, tempo_bpm)

    def voicing(label):
        """→ [(pitch, velocity)]: chord tones at 72, the slash bass accented at 80."""
        root, quality, bass = split_chord_label(label)
        if root is None:
            return []
        base = 48 + NOTE_TO_PC[root]  # voicings around C3
        notes = [
            (base + iv, 72)
            for iv in QUALITY_INTERVALS.get(quality or "maj", QUALITY_INTERVALS["maj"])
        ]
        if bass:
            notes.append((36 + NOTE_TO_PC[bass], 80))
        return notes

    notes: list[tuple[float, float, int, int]] = []
    for seg in chords:
        pitches = voicing(seg.label)
        if not pitches:
            continue
        if per_beat and beat_times is not None and len(beat_times) > 1:
            bt = np.asarray(beat_times, dtype=float)
            strikes = bt[(bt >= seg.start) & (bt < seg.end)]
            if strikes.size == 0:
                strikes = np.asarray([seg.start])
            for i, t in enumerate(strikes):
                end = strikes[i + 1] if i + 1 < len(strikes) else seg.end
                dur_q = max(0.125, (float(end) - float(t)) * 0.9 / sec_per_q)
                for p, vel in pitches:
                    notes.append((float(t) / sec_per_q, dur_q, p, vel))
        else:
            start_q = float(seg.start) / sec_per_q
            dur_q = max(0.25, (float(seg.end) - float(seg.start)) / sec_per_q)
            for p, vel in pitches:
                notes.append((start_q, dur_q, p, vel))
    write_midi_notes(path, notes, tempo_bpm=tempo_bpm)
