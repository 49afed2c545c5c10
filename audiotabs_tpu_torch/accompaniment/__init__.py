"""Accompaniment mode: strum onsets and chord shapes (counterpart of audiotabs_tpu/accompaniment/)."""

from .shapes import Shape, pick_shape_for_chord, shape_pitches, shape_positions, shape_to_dict
from .strum import detect_strum_onsets

__all__ = [
    "detect_strum_onsets",
    "Shape",
    "pick_shape_for_chord",
    "shape_pitches",
    "shape_positions",
    "shape_to_dict",
]
