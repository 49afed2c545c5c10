"""Guitar fretboard model: tunings and pitch↔position mapping.

Capability parity with the reference's fretboard module
(reference: backend/app/services/guitar/fretboard.py:6-60). Strings are
numbered 1 (highest) to 6 (lowest); tunings are MIDI numbers of the open
strings ordered low→high.

The port's copy of ``audiotabs_tpu/tab/fretboard.py``: host code, arithmetic unchanged.
"""

from __future__ import annotations

from typing import Iterable

STANDARD_TUNING = (40, 45, 50, 55, 59, 64)  # E2 A2 D3 G3 B3 E4

TUNINGS: dict[str, tuple[int, ...]] = {
    "standard": STANDARD_TUNING,
    "drop_d": (38, 45, 50, 55, 59, 64),
    "open_g": (38, 43, 50, 55, 59, 62),
    "dadgad": (38, 45, 50, 55, 57, 62),
    "half_step_down": (39, 44, 49, 54, 58, 63),
}

MAX_FRET_DEFAULT = 24


def get_tuning(name: str | None) -> tuple[int, ...]:
    if not name:
        return STANDARD_TUNING
    return TUNINGS.get(str(name).strip().lower(), STANDARD_TUNING)


def pitch_to_fret_options(
    pitch_midi: int, tuning: tuple[int, ...] = STANDARD_TUNING, *, max_fret: int = MAX_FRET_DEFAULT
) -> list[tuple[int, int]]:
    """All playable (string, fret) pairs for a MIDI pitch, string 1 = highest."""
    out = []
    for i, open_pitch in enumerate(tuning):
        fret = int(pitch_midi) - int(open_pitch)
        if 0 <= fret <= max_fret:
            out.append((6 - i, fret))
    return out


def positions_to_pitches(
    positions: Iterable[tuple[int, int]], tuning: tuple[int, ...] = STANDARD_TUNING
) -> list[int]:
    pitches = []
    for string_num, fret in positions:
        idx = 6 - int(string_num)
        if 0 <= idx < len(tuning):
            pitches.append(int(tuning[idx]) + int(fret))
    return pitches
