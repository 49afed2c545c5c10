"""Canonical open-position chord shapes and pitch-set matching.

Capability parity with the reference's open-chord matcher
(reference: backend/app/services/guitar/open_chords.py:9-124). Shapes are
frets for strings 6→1; -1 = muted.

The port's copy of ``audiotabs_tpu/tab/open_chords.py``: host code, arithmetic unchanged.
"""

from __future__ import annotations

from ..theory.vocabulary import split_chord_label
from .fretboard import STANDARD_TUNING, positions_to_pitches

OPEN_POSITION_CHORDS: dict[str, tuple[int, int, int, int, int, int]] = {
    "C:maj": (-1, 3, 2, 0, 1, 0),
    "G:maj": (3, 2, 0, 0, 0, 3),
    "D:maj": (-1, -1, 0, 2, 3, 2),
    "A:maj": (-1, 0, 2, 2, 2, 0),
    "E:maj": (0, 2, 2, 1, 0, 0),
    "A:min": (-1, 0, 2, 2, 1, 0),
    "E:min": (0, 2, 2, 0, 0, 0),
    "D:min": (-1, -1, 0, 2, 3, 1),
    "C:7": (-1, 3, 2, 3, 1, 0),
    "G:7": (3, 2, 0, 0, 0, 1),
    "D:7": (-1, -1, 0, 2, 1, 2),
    "A:7": (-1, 0, 2, 0, 2, 0),
    "E:7": (0, 2, 0, 1, 0, 0),
    "C:maj7": (-1, 3, 2, 0, 0, 0),
    "A:min7": (-1, 0, 2, 0, 1, 0),
    "E:min7": (0, 2, 0, 0, 0, 0),
    "D:min7": (-1, -1, 0, 2, 1, 1),
}


def shape_to_positions(shape: tuple[int, ...]) -> list[tuple[int, int]]:
    """Shape (frets for strings 6→1, -1 muted) → [(string, fret), ...]."""
    return [(6 - i, f) for i, f in enumerate(shape) if f >= 0]


def _find_shape(pitches: list[int], chord_label: str, tuning: tuple[int, ...]):
    root, quality, _ = split_chord_label(chord_label)
    if root and quality:
        key = f"{root}:{quality}"
        if key in OPEN_POSITION_CHORDS:
            return shape_to_positions(OPEN_POSITION_CHORDS[key])

    target = {p % 12 for p in pitches}
    if not target:
        return []
    best, best_extra = [], None
    for shape in OPEN_POSITION_CHORDS.values():
        positions = shape_to_positions(shape)
        pcs = {p % 12 for p in positions_to_pitches(positions, tuning)}
        if not target.issubset(pcs):
            continue
        extra = len(pcs) - len(target)
        if best_extra is None or extra < best_extra:
            best, best_extra = positions, extra
    return best


def matches_open_chord(
    pitches: list[int], chord_label: str, *, tuning: tuple[int, ...] = STANDARD_TUNING
) -> tuple[bool, list[tuple[int, int]]]:
    """If the pitch set fits a known open shape, return per-pitch positions.

    Output positions are aligned with the input pitch order; each pitch takes
    an unused string sounding that pitch (exact match first, then same
    pitch class).
    """
    if not pitches:
        return False, []
    shape_positions = _find_shape(pitches, chord_label, tuning)
    if not shape_positions:
        return False, []

    shape_pitches = positions_to_pitches(shape_positions, tuning)
    exact: dict[int, list[tuple[int, int]]] = {}
    by_pc: dict[int, list[tuple[int, int]]] = {}
    for pos, p in zip(shape_positions, shape_pitches):
        exact.setdefault(p, []).append(pos)
        by_pc.setdefault(p % 12, []).append(pos)

    used: set[int] = set()
    out: list[tuple[int, int]] = []
    for p in pitches:
        options = exact.get(int(p), []) or by_pc.get(int(p) % 12, [])
        picked = next((pos for pos in options if pos[0] not in used), None)
        if picked is None:
            return False, []
        used.add(picked[0])
        out.append(picked)
    return True, out
