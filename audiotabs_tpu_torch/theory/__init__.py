"""Music theory: chord vocabulary, simplification, key, quantisation (counterpart of audiotabs_tpu/theory/)."""

from .vocabulary import (
    NOTE_NAMES_FLAT,
    NOTE_NAMES_SHARP,
    NOTE_TO_PC,
    QUALITY_INTERVALS,
    chord_tone_pcs,
    format_chord_label,
    normalize_chord_label,
    pc_to_note,
    split_chord_label,
)

__all__ = [
    "NOTE_NAMES_FLAT",
    "NOTE_NAMES_SHARP",
    "NOTE_TO_PC",
    "QUALITY_INTERVALS",
    "chord_tone_pcs",
    "format_chord_label",
    "normalize_chord_label",
    "pc_to_note",
    "split_chord_label",
]
