"""Self-contained MusicXML (score-partwise) writer.

Replaces the reference's music21-based exporter (reference: backend/app/
services/musicxml/export.py:150-403) with a direct xml.etree serializer:
a notation part plus an optional 6-line TAB part (staff-tuning + per-note
string/fret technicals), chord symbols as <harmony> elements at
beat-interpolated offsets, ties, dots, tuplets, and slash noteheads for
accompaniment scores.

The port's copy of ``audiotabs_tpu/score/musicxml.py``: host code, arithmetic unchanged.
"""

from __future__ import annotations

import xml.etree.ElementTree as ET
from pathlib import Path
from typing import List, Optional, Sequence

import numpy as np

from ..schemas import ScoreData
from ..theory.quantize import duration_to_quarters, parse_time_signature, to_beats
from .segments import Segment

DIVISIONS = 12  # per quarter: LCM of the 1/4 and 1/3 grids

_TYPE_NAME = {"w": "whole", "h": "half", "q": "quarter", "8": "eighth", "16": "16th", "32": "32nd"}

_KIND_MAP = {
    "maj": "major", "min": "minor", "7": "dominant", "maj7": "major-seventh",
    "min7": "minor-seventh", "dim": "diminished", "dim7": "diminished-seventh",
    "min7b5": "half-diminished", "aug": "augmented", "sus2": "suspended-second",
    "sus4": "suspended-fourth", "6": "major-sixth", "min6": "minor-sixth",
    "9": "dominant-ninth", "maj9": "major-ninth", "min9": "minor-ninth",
    "7b9": "dominant-ninth", "7#9": "dominant-ninth", "add9": "major",
}

# MIDI open-string pitches low→high for the TAB staff-tuning element
_STEP_FOR_PC = {
    0: ("C", 0), 1: ("C", 1), 2: ("D", 0), 3: ("E", -1), 4: ("E", 0), 5: ("F", 0),
    6: ("F", 1), 7: ("G", 0), 8: ("A", -1), 9: ("A", 0), 10: ("B", -1), 11: ("B", 0),
}


def _vf_key_to_pitch(key: str) -> tuple[str, int, int]:
    """VexFlow key 'f#/4' → (step, alter, octave)."""
    name, octave_s = key.split("/")
    name = name.strip().lower()
    step = name[0].upper()
    alter = 0
    if len(name) > 1:
        alter = 1 if name[1] == "#" else -1
    return step, alter, int(octave_s)


def _sub(parent, tag, text=None, **attrs):
    el = ET.SubElement(parent, tag, {k.replace("_", "-"): str(v) for k, v in attrs.items()})
    if text is not None:
        el.text = str(text)
    return el


def _harmony_element(label: str) -> Optional[ET.Element]:
    from ..theory.vocabulary import split_chord_label

    root, quality, bass = split_chord_label(label)
    if root is None:
        return None
    h = ET.Element("harmony")
    r = _sub(h, "root")
    _sub(r, "root-step", root[0])
    if len(root) > 1:
        _sub(r, "root-alter", 1 if root[1] == "#" else -1)
    kind = _KIND_MAP.get(quality or "maj", "major")
    kind_el = _sub(h, "kind", kind)
    if quality and quality != "maj":
        kind_el.set("text", quality)
    if bass:
        b = _sub(h, "bass")
        _sub(b, "bass-step", bass[0])
        if len(bass) > 1:
            _sub(b, "bass-alter", 1 if bass[1] == "#" else -1)
    return h


def _attributes(measure, *, fifths, num, den, clef: str, tuning: Sequence[int] | None):
    attrs = _sub(measure, "attributes")
    _sub(attrs, "divisions", DIVISIONS)
    if fifths is not None:
        k = _sub(attrs, "key")
        _sub(k, "fifths", int(fifths))
    t = _sub(attrs, "time")
    _sub(t, "beats", num)
    _sub(t, "beat-type", den)
    if clef == "TAB":
        sd = _sub(attrs, "staff-details")
        _sub(sd, "staff-lines", 6)
        if tuning:
            for line, midi in enumerate(tuning, start=1):
                st = _sub(sd, "staff-tuning", line=line)
                step, alter = _STEP_FOR_PC[midi % 12]
                _sub(st, "tuning-step", step)
                if alter:
                    _sub(st, "tuning-alter", alter)
                _sub(st, "tuning-octave", midi // 12 - 1)
        c = _sub(attrs, "clef")
        _sub(c, "sign", "TAB")
        _sub(c, "line", 5)
    else:
        c = _sub(attrs, "clef")
        _sub(c, "sign", "G")
        _sub(c, "line", 2)


def _emit_note(
    measure,
    item,
    *,
    dur_div: int,
    slash: bool,
    tab_position: Optional[list[tuple[int, int]]] = None,
):
    """Emit one ScoreItem as <note> elements (chord notes share the onset)."""
    if item.rest or not item.keys:
        n = _sub(measure, "note")
        _sub(n, "rest")
        _sub(n, "duration", dur_div)
        if item.duration in _TYPE_NAME:
            _sub(n, "type", _TYPE_NAME[item.duration])
        for _ in range(int(item.dots or 0)):
            _sub(n, "dot")
        return

    for i, key in enumerate(item.keys):
        step, alter, octave = _vf_key_to_pitch(key)
        n = _sub(measure, "note")
        if i > 0:
            _sub(n, "chord")
        p = _sub(n, "pitch")
        _sub(p, "step", step)
        if alter:
            _sub(p, "alter", alter)
        _sub(p, "octave", octave)
        _sub(n, "duration", dur_div)
        if item.tie in ("start", "continue"):
            _sub(n, "tie", type="start")
        if item.tie in ("stop", "continue"):
            _sub(n, "tie", type="stop")
        _sub(n, "type", _TYPE_NAME.get(item.duration, "quarter"))
        for _ in range(int(item.dots or 0)):
            _sub(n, "dot")
        if item.tuplet is not None:
            tm = _sub(n, "time-modification")
            _sub(tm, "actual-notes", item.tuplet.num_notes)
            _sub(tm, "normal-notes", item.tuplet.notes_occupied)
        if slash:
            _sub(n, "notehead", "slash")
        notations = None
        if item.tie is not None:
            notations = _sub(n, "notations")
            if item.tie in ("start", "continue"):
                _sub(notations, "tied", type="start")
            if item.tie in ("stop", "continue"):
                _sub(notations, "tied", type="stop")
        if tab_position is not None and i < len(tab_position):
            s, f = tab_position[i]
            if notations is None:
                notations = _sub(n, "notations")
            tech = _sub(notations, "technical")
            _sub(tech, "string", s)
            _sub(tech, "fret", f)


def _chord_offsets_q(
    chords: List[Segment] | None,
    tempo_bpm: float,
    beat_times: np.ndarray | None,
    pickup_quarters: float,
) -> list[tuple[float, ET.Element]]:
    out: list[tuple[float, ET.Element]] = []
    if not chords:
        return out
    sec_per_q = 60.0 / (tempo_bpm if tempo_bpm else 120.0)
    for seg in sorted(chords, key=lambda c: float(c.start)):
        el = _harmony_element(str(seg.label or "N"))
        if el is None:
            continue
        if beat_times is not None and len(beat_times) > 1:
            off = float(to_beats(np.array([seg.start]), beat_times)[0])
        else:
            off = float(seg.start) / sec_per_q
        out.append((max(0.0, off + pickup_quarters), el))
    return out


def export_musicxml(
    out_path: Path | str,
    score_data: ScoreData,
    *,
    tempo_bpm: float,
    time_signature: str = "4/4",
    key_signature_fifths: int | None = None,
    title: str = "Transcription",
    instrument: str = "piano",
    chords: List[Segment] | None = None,
    beat_times: np.ndarray | None = None,
    pickup_quarters: float = 0.0,
    slash_notation: bool = False,
    tab_positions: list[list[list[tuple[int, int]]]] | None = None,
    tab_tuning: Sequence[int] = (40, 45, 50, 55, 59, 64),
    midi_path: Path | str | None = None,
) -> None:
    out_path = Path(out_path)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    num, den = parse_time_signature(time_signature)

    root = ET.Element("score-partwise", version="4.0")
    work = _sub(root, "work")
    _sub(work, "work-title", title)
    ident = _sub(root, "identification")
    creator = _sub(ident, "creator", "Audio Tabs AI", type="composer")
    del creator

    part_list = _sub(root, "part-list")
    has_tab = tab_positions is not None
    if has_tab:
        pg = _sub(part_list, "part-group", type="start", number="1")
        _sub(pg, "group-symbol", "bracket")
        _sub(pg, "group-barline", "yes")
    sp = _sub(part_list, "score-part", id="P1")
    _sub(sp, "part-name", "Guitar" if instrument == "guitar" else "Piano")
    if has_tab:
        sp2 = _sub(part_list, "score-part", id="P2")
        _sub(sp2, "part-name", "Guitar TAB")
        _sub(part_list, "part-group", type="stop", number="1")

    harmony_queue = _chord_offsets_q(chords, tempo_bpm, beat_times, pickup_quarters)

    def build_part(part_id: str, is_tab: bool) -> None:
        part = _sub(root, "part", id=part_id)
        hq = list(harmony_queue) if not is_tab else []
        global_off = 0.0
        for m_idx, meas in enumerate(score_data.measures):
            m = _sub(part, "measure", number=meas.number)
            if m_idx == 0:
                _attributes(
                    m,
                    fifths=key_signature_fifths,
                    num=num,
                    den=den,
                    clef="TAB" if is_tab else "G",
                    tuning=tab_tuning if is_tab else None,
                )
                if not is_tab:
                    d = _sub(m, "direction", placement="above")
                    dt = _sub(d, "direction-type")
                    metro = _sub(dt, "metronome")
                    _sub(metro, "beat-unit", "quarter")
                    _sub(metro, "per-minute", int(round(tempo_bpm)))
                    _sub(d, "sound", tempo=float(tempo_bpm))
            for item_idx, item in enumerate(meas.items):
                dq = duration_to_quarters(item)
                # flush harmonies that start at/before this item
                while hq and hq[0][0] < global_off + dq - 1e-6:
                    m.append(hq.pop(0)[1])
                dur_div = max(1, int(round(dq * DIVISIONS)))
                tab_pos = None
                if is_tab and tab_positions and m_idx < len(tab_positions):
                    mp = tab_positions[m_idx]
                    if item_idx < len(mp) and mp[item_idx]:
                        tab_pos = mp[item_idx]
                _emit_note(
                    m,
                    item,
                    dur_div=dur_div,
                    slash=slash_notation and not is_tab,
                    tab_position=tab_pos,
                )
                global_off += dq

    build_part("P1", is_tab=False)
    if has_tab:
        build_part("P2", is_tab=True)

    ET.indent(root, space=" ")
    body = ET.tostring(root, encoding="unicode")
    doc = (
        '<?xml version="1.0" encoding="UTF-8"?>\n'
        '<!DOCTYPE score-partwise PUBLIC "-//Recordare//DTD MusicXML 4.0 Partwise//EN" '
        '"http://www.musicxml.org/dtds/partwise.dtd">\n' + body
    )
    out_path.write_text(doc)

    if midi_path is not None:
        from .midi import write_midi_from_score

        write_midi_from_score(midi_path, score_data, tempo_bpm=tempo_bpm)
