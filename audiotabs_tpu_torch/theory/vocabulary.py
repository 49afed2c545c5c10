"""Chord vocabulary constants (a copy of those in audiotabs_tpu/theory/vocabulary.py)."""

from __future__ import annotations

NOTE_NAMES_SHARP = ["C", "C#", "D", "D#", "E", "F", "F#", "G", "G#", "A", "A#", "B"]
NOTE_NAMES_FLAT = ["C", "Db", "D", "Eb", "E", "F", "Gb", "G", "Ab", "A", "Bb", "B"]

NOTE_TO_PC: dict[str, int] = {}
for _i, _n in enumerate(NOTE_NAMES_SHARP):
    NOTE_TO_PC[_n] = _i
for _i, _n in enumerate(NOTE_NAMES_FLAT):
    NOTE_TO_PC.setdefault(_n, _i)
NOTE_TO_PC.update({"B#": 0, "Fb": 4, "E#": 5, "Cb": 11})

# quality → semitone intervals from the root (the chord tones)
QUALITY_INTERVALS: dict[str, tuple[int, ...]] = {
    "maj": (0, 4, 7),
    "min": (0, 3, 7),
    "7": (0, 4, 7, 10),
    "maj7": (0, 4, 7, 11),
    "min7": (0, 3, 7, 10),
    "dim": (0, 3, 6),
    "dim7": (0, 3, 6, 9),
    "min7b5": (0, 3, 6, 10),
    "aug": (0, 4, 8),
    "sus2": (0, 2, 7),
    "sus4": (0, 5, 7),
    "6": (0, 4, 7, 9),
    "min6": (0, 3, 7, 9),
    "9": (0, 4, 7, 10, 14),
    "maj9": (0, 4, 7, 11, 14),
    "min9": (0, 3, 7, 10, 14),
    "7b9": (0, 4, 7, 10, 13),
    "7#9": (0, 4, 7, 10, 15),
    "add9": (0, 4, 7, 14),
}
