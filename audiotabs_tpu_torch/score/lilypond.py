"""LilyPond lead-sheet engraving (Real-Book style slash notation).

Capability parity with the reference's engraver (reference: backend/app/
services/engraving/lilypond.py:30-336): chord labels → \\chordmode tokens,
beat-grid quantization of segments into whole-measure chords with gap
filling, rehearsal marks every 8 bars, and a subprocess render to PDF when
the lilypond binary exists (it stays a host-side tool, as in the reference).

The port's copy of ``audiotabs_tpu/score/lilypond.py``: host code, arithmetic unchanged.
"""

from __future__ import annotations

import shutil
import subprocess
from pathlib import Path

import numpy as np

from ..theory.vocabulary import split_chord_label

_LY_NOTE = {
    "C": "c", "C#": "cis", "Db": "des", "D": "d", "D#": "dis", "Eb": "ees",
    "E": "e", "F": "f", "F#": "fis", "Gb": "ges", "G": "g", "G#": "gis",
    "Ab": "aes", "A": "a", "A#": "ais", "Bb": "bes", "B": "b", "Cb": "ces",
    "E#": "eis", "B#": "bis", "Fb": "fes",
}

_LY_QUALITY = {
    "maj": "", "min": ":m", "7": ":7", "maj7": ":maj7", "min7": ":m7",
    "dim": ":dim", "dim7": ":dim7", "min7b5": ":m7.5-", "aug": ":aug",
    "sus2": ":sus2", "sus4": ":sus4", "6": ":6", "min6": ":m6",
    "9": ":9", "maj9": ":maj9", "min9": ":m9", "7b9": ":7.9-",
    "7#9": ":7.9+", "add9": ":5.9",
}


def chord_to_lily(label: str, duration: str = "1") -> str:
    root, quality, bass = split_chord_label(label)
    if root is None:
        return f"r{duration}"
    tok = _LY_NOTE.get(root, "c") + duration + _LY_QUALITY.get(quality or "maj", "")
    if bass and bass in _LY_NOTE:
        tok += f"/{_LY_NOTE[bass]}"
    return tok


def _chords_per_measure(chords, tempo_bpm: float, beat_times, beats_per_bar: int = 4) -> list[str]:
    """Assign each measure the chord sounding at its downbeat (gap → repeat)."""
    if not chords:
        return []
    sec_per_beat = 60.0 / (tempo_bpm if tempo_bpm and tempo_bpm > 0 else 120.0)
    if beat_times is not None and len(beat_times) > 1:
        bt = np.asarray(beat_times, dtype=np.float64)
        end_t = float(bt[-1]) + sec_per_beat
    else:
        bt = None
        end_t = max(float(c.end) for c in chords)
    bar_s = beats_per_bar * sec_per_beat
    n_bars = max(1, int(np.ceil(end_t / bar_s)))

    labels = []
    last = "N"
    for m in range(n_bars):
        t = m * bar_s + 1e-3
        lbl = None
        for c in chords:
            if c.start <= t < c.end:
                lbl = c.label
                break
        if lbl is None or lbl == "N":
            lbl = last
        labels.append(lbl)
        last = lbl
    return labels


def build_lilypond_score(
    chords,
    *,
    tempo_bpm: float,
    beat_times=None,
    title: str = "Lead Sheet",
    key_signature=None,
    beats_per_bar: int = 4,
) -> str:
    """Render a Real-Book-style .ly source string."""
    # the title is the job id (CLI jobs: the input filename stem) — escape
    # LilyPond string syntax so a quote/backslash can't break the source
    title = title.replace("\\", "\\\\").replace('"', '\\"')
    measures = _chords_per_measure(chords, tempo_bpm, beat_times, beats_per_bar)
    if not measures:
        measures = ["N"]

    # whole-measure chord duration for the meter (4/4 → "1", 3/4 → "2.", 2/4 → "2")
    bar_dur = {4: "1", 3: "2.", 2: "2"}.get(beats_per_bar, "1")
    chord_tokens = []
    for i, lbl in enumerate(measures):
        chord_tokens.append(chord_to_lily(lbl, bar_dur))
        if (i + 1) % 4 == 0:
            chord_tokens.append("\n    ")

    # Real-Book rehearsal marks every 8 bars starting at bar 1
    # (reference: engraving/lilypond.py:224-232 — mark A at bar 1, B at 9, …)
    slash_bar = "b'4 " + " ".join(["b'"] * (beats_per_bar - 1)) + " |"
    slash_lines = []
    for i in range(len(measures)):
        if i % 8 == 0:
            letter = chr(65 + (i // 8) % 26)
            slash_lines.append(f'\\mark \\markup {{ \\box \\bold "{letter}" }}')
        slash_lines.append(slash_bar)
    slash_body = "\n    ".join(slash_lines)

    key_ly = ""
    if key_signature is not None:
        tonic = _LY_NOTE.get(getattr(key_signature, "tonic", "C"), "c")
        mode = "\\minor" if getattr(key_signature, "mode", "major") == "minor" else "\\major"
        key_ly = f"\\key {tonic} {mode}"

    return f"""\\version "2.24.0"
\\header {{
  title = "{title}"
  tagline = ##f
}}

harmonies = \\chordmode {{
    {' '.join(chord_tokens)}
}}

slashes = {{
    \\override NoteHead.style = #'slash
    \\override NoteHead.no-ledgers = ##t
    {key_ly}
    \\time {beats_per_bar}/4
    \\tempo 4 = {int(round(tempo_bpm))}
    {slash_body}
}}

\\score {{
  <<
    \\new ChordNames \\harmonies
    \\new Staff \\slashes
  >>
  \\layout {{ }}
}}
"""


def render_lilypond_pdf(ly_path: Path | str, pdf_path: Path | str) -> bool:
    """Render .ly → PDF via the lilypond binary; False when absent."""
    binary = shutil.which("lilypond")
    if binary is None:
        return False
    ly_path, pdf_path = Path(ly_path), Path(pdf_path)
    subprocess.run(
        [binary, "-o", str(pdf_path.with_suffix("")), str(ly_path)],
        check=True,
        capture_output=True,
        timeout=120,
    )
    return pdf_path.exists()
