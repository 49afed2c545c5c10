"""Chord label grammar: parsing, normalization, chord tones.

Capability parity with the reference's vocabulary module and the pipeline's
chord-tone tables (reference: backend/app/services/chords/
chord_vocabulary.py:5-246, services/pipeline.py:475-538), consolidated into
one table-driven module: every supported quality carries its interval set,
so chord-tone queries and label parsing share one source of truth.

Label grammar: ``Root[:quality][/bass]`` (Harte-style, e.g. "G:maj",
"A:min7/E") plus common plain spellings ("Am7", "F#m", "Bb").

The port's copy of ``audiotabs_tpu/theory/vocabulary.py``: host code, arithmetic unchanged.
"""

from __future__ import annotations

import re

NOTE_NAMES_SHARP = ["C", "C#", "D", "D#", "E", "F", "F#", "G", "G#", "A", "A#", "B"]
NOTE_NAMES_FLAT = ["C", "Db", "D", "Eb", "E", "F", "Gb", "G", "Ab", "A", "Bb", "B"]

NOTE_TO_PC: dict[str, int] = {}
for _i, _n in enumerate(NOTE_NAMES_SHARP):
    NOTE_TO_PC[_n] = _i
for _i, _n in enumerate(NOTE_NAMES_FLAT):
    NOTE_TO_PC.setdefault(_n, _i)
NOTE_TO_PC.update({"B#": 0, "Fb": 4, "E#": 5, "Cb": 11})

NO_CHORD_LABELS = {"N", "NO_CHORD", "NOCHORD", "N.C.", "NC", "X", "NONE"}

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

# spelling aliases → canonical quality token
_QUALITY_ALIASES: dict[str, str] = {
    "": "maj", "major": "maj", "m": "min", "minor": "min",
    "m7": "min7", "m6": "min6", "m9": "min9",
    "maj6": "6", "hdim7": "min7b5", "m7b5": "min7b5", "sus": "sus4",
}

_ROOT_RE = re.compile(r"^([A-Ga-g])([#b]?)(.*)$")


def _canon_note(name: str | None) -> str | None:
    if not name:
        return None
    name = name.strip()
    if not name:
        return None
    cand = name[0].upper() + name[1:]
    return cand if cand in NOTE_TO_PC else None


def pc_to_note(pc: int, use_flats: bool = False) -> str:
    names = NOTE_NAMES_FLAT if use_flats else NOTE_NAMES_SHARP
    return names[int(pc) % 12]


def _canon_quality(raw: str) -> str:
    q = raw.strip().lower().replace("(", "").replace(")", "").replace(" ", "")
    if q in QUALITY_INTERVALS:
        return q
    if q in _QUALITY_ALIASES:
        return _QUALITY_ALIASES[q]
    # fuzzy fallbacks, most-specific first
    for pat, tok in (
        ("sus2", "sus2"), ("sus", "sus4"), ("hdim", "min7b5"), ("m7b5", "min7b5"),
        ("dim7", "dim7"), ("dim", "dim"), ("aug", "aug"),
    ):
        if pat in q:
            return tok
    if "maj" in q and "9" in q:
        return "maj9"
    if ("min" in q or q.startswith("m")) and "9" in q:
        return "min9"
    if "7b9" in q or "b9" in q:
        return "7b9"
    if "7#9" in q or "#9" in q:
        return "7#9"
    if "maj" in q and "7" in q:
        return "maj7"
    if ("min" in q or q.startswith("m")) and "7" in q:
        return "min7"
    if "9" in q:
        return "9"
    if "7" in q:
        return "7"
    if "min" in q or q.startswith("m"):
        return "min"
    return "maj"


def _bass_degree_interval(quality: str, token: str) -> int | None:
    """Interval for a scale-degree bass like '3', 'b7' (slash-chord notation)."""
    token = token.strip().lower()
    acc = 0
    if token[:1] in ("b", "#"):
        acc = -1 if token[0] == "b" else 1
        token = token[1:]
    ivs = QUALITY_INTERVALS.get(quality, QUALITY_INTERVALS["maj"])
    degree_map = {"3": 1, "5": 2, "7": 3}
    if token in degree_map and degree_map[token] < len(ivs):
        return ivs[degree_map[token]] + acc
    extras = {"6": 9, "9": 14, "11": 17, "13": 21}
    if token in extras:
        return extras[token] + acc
    return None


def split_chord_label(label: str | None) -> tuple[str | None, str | None, str | None]:
    """Parse a label → (root, canonical quality, bass note) or (None,)*3 for N."""
    if not label:
        return None, None, None
    raw = label.strip()
    if raw.upper() in NO_CHORD_LABELS:
        return None, None, None

    main, _, bass_raw = raw.partition("/")
    bass_raw = bass_raw.strip() or None

    if ":" in main:
        root_raw, qual_raw = main.split(":", 1)
    else:
        m = _ROOT_RE.match(main.strip())
        if not m:
            return None, None, None
        root_raw = m.group(1).upper() + m.group(2)
        qual_raw = m.group(3)

    root = _canon_note(root_raw)
    if root is None:
        return None, None, None
    quality = _canon_quality(qual_raw)

    bass = None
    if bass_raw:
        bass = _canon_note(bass_raw)
        if bass is None:
            iv = _bass_degree_interval(quality, bass_raw)
            if iv is not None:
                bass = pc_to_note(NOTE_TO_PC[root] + iv)
    return root, quality, bass


def format_chord_label(root: str, quality: str, bass: str | None = None) -> str:
    label = f"{root}:{quality}" if quality else root
    return f"{label}/{bass}" if bass else label


def normalize_chord_label(label: str) -> str:
    """Normalize any recognizer output to root:quality[/bass], or 'N'."""
    root, quality, bass = split_chord_label(label)
    if root is None or quality is None:
        return "N"
    return format_chord_label(root, quality, bass)


def chord_tone_pcs(label: str) -> set[int]:
    """Pitch classes of the chord tones for a label ('' for N).

    Consolidates the pipeline's interval tables
    (reference: services/pipeline.py:475-538).
    """
    root, quality, bass = split_chord_label(label)
    if root is None:
        return set()
    root_pc = NOTE_TO_PC[root]
    ivs = QUALITY_INTERVALS.get(quality or "maj", QUALITY_INTERVALS["maj"])
    pcs = {(root_pc + iv) % 12 for iv in ivs}
    if bass:
        pcs.add(NOTE_TO_PC[bass])
    return pcs
