"""Chord recognition: templates, extraction, segments (counterpart of audiotabs_tpu/chords/)."""

from .extract import extract_chords
from .segments import beat_sync_majority, frames_to_segments
from .templates import build_chord_library, emission_probs

__all__ = [
    "build_chord_library",
    "emission_probs",
    "extract_chords",
    "beat_sync_majority",
    "frames_to_segments",
]
