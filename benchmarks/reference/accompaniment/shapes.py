"""Chord shape selection for accompaniment (open + E/A-form barres).

Capability parity with the reference (reference: backend/app/services/
accompaniment/shapes.py:26-145): 8 open shapes, barre transposition of the
E and A forms, and the shape-choice cost (0.7·avg fret + 0.25·max fret +
0.35·span + jump-from-previous − 0.5 open bonus).

The port's copy of ``audiotabs_tpu/accompaniment/shapes.py``: host code, arithmetic unchanged.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable

from ..tab.fretboard import STANDARD_TUNING
from ..theory.vocabulary import NOTE_TO_PC, split_chord_label


@dataclass(frozen=True)
class Shape:
    frets: tuple[int, int, int, int, int, int]  # strings 6 → 1, -1 = muted
    root: str
    quality: str
    label: str

    @property
    def position(self) -> int:
        nz = [f for f in self.frets if f > 0]
        return min(nz) if nz else 0


OPEN_SHAPES: dict[tuple[str, str], tuple[int, int, int, int, int, int]] = {
    ("C", "maj"): (-1, 3, 2, 0, 1, 0),
    ("A", "maj"): (-1, 0, 2, 2, 2, 0),
    ("A", "min"): (-1, 0, 2, 2, 1, 0),
    ("D", "maj"): (-1, -1, 0, 2, 3, 2),
    ("D", "min"): (-1, -1, 0, 2, 3, 1),
    ("E", "maj"): (0, 2, 2, 1, 0, 0),
    ("E", "min"): (0, 2, 2, 0, 0, 0),
    ("G", "maj"): (3, 2, 0, 0, 0, 3),
}

_E_MAJ, _E_MIN = (0, 2, 2, 1, 0, 0), (0, 2, 2, 0, 0, 0)
_A_MAJ, _A_MIN = (-1, 0, 2, 2, 2, 0), (-1, 0, 2, 2, 1, 0)


def _triad_quality(label: str) -> tuple[str | None, str | None]:
    """Collapse any quality to maj/min triads (shapes.py:_parse_chord_label)."""
    root, quality, _ = split_chord_label(label)
    if root is None:
        return None, None
    minor = quality in ("min", "min7", "dim", "min7b5", "dim7", "min6", "min9")
    return root, "min" if minor else "maj"


def _transpose(shape: Iterable[int], fret: int) -> tuple[int, ...]:
    return tuple(-1 if f < 0 else (fret if f == 0 else f + fret) for f in shape)


def pick_shape_for_chord(label: str, prev_shape: Shape | None = None) -> Shape | None:
    root, quality = _triad_quality(label)
    if root is None:
        return None
    pc = NOTE_TO_PC.get(root)
    if pc is None:
        return None

    candidates: list[Shape] = []
    if (root, quality) in OPEN_SHAPES:
        candidates.append(Shape(OPEN_SHAPES[(root, quality)], root, quality, label))
    e_shape = _E_MAJ if quality == "maj" else _E_MIN
    a_shape = _A_MAJ if quality == "maj" else _A_MIN
    candidates.append(Shape(_transpose(e_shape, (pc - NOTE_TO_PC["E"]) % 12), root, quality, label))
    candidates.append(Shape(_transpose(a_shape, (pc - NOTE_TO_PC["A"]) % 12), root, quality, label))

    def cost(s: Shape) -> float:
        frets = [f for f in s.frets if f >= 0]
        if not frets:
            return 1e9
        avg_f, min_f, max_f = sum(frets) / len(frets), min(frets), max(frets)
        c = avg_f * 0.7 + max_f * 0.25 + (max_f - min_f) * 0.35
        if any(f == 0 for f in frets):
            c -= 0.5
        if prev_shape is not None:
            prev_frets = [f for f in prev_shape.frets if f >= 0]
            prev_avg = sum(prev_frets) / len(prev_frets) if prev_frets else 0.0
            c += abs(s.position - prev_shape.position) * 0.9 + abs(avg_f - prev_avg) * 0.4
        return c

    return min(candidates, key=cost)


def shape_pitches(shape: Shape) -> list[int]:
    return [STANDARD_TUNING[i] + f for i, f in enumerate(shape.frets) if f >= 0]


def shape_positions(shape: Shape) -> list[tuple[int, int]]:
    return [(6 - i, f) for i, f in enumerate(shape.frets) if f >= 0]


def shape_to_dict(shape: Shape) -> dict:
    return {
        "frets": list(shape.frets),
        "root": shape.root,
        "quality": shape.quality,
        "label": shape.label,
        "position": shape.position,
    }
