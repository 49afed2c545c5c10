"""Guitar tablature: fretboard, open chords, the tab optimizer (counterpart of audiotabs_tpu/tab/)."""

from .fretboard import STANDARD_TUNING, TUNINGS, get_tuning, pitch_to_fret_options, positions_to_pitches
from .open_chords import OPEN_POSITION_CHORDS, matches_open_chord
from .optimizer import (
    FretPosition,
    HandPosition,
    TabEvent,
    TabOptimizationResult,
    optimize_tab_positions,
    optimize_tab_positions_for_events,
)

__all__ = [
    "STANDARD_TUNING",
    "TUNINGS",
    "get_tuning",
    "pitch_to_fret_options",
    "positions_to_pitches",
    "OPEN_POSITION_CHORDS",
    "matches_open_chord",
    "FretPosition",
    "HandPosition",
    "TabEvent",
    "TabOptimizationResult",
    "optimize_tab_positions",
    "optimize_tab_positions_for_events",
]
