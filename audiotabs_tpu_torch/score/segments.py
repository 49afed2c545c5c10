"""Chord segment record shared by chord extraction and export.

Same fields as the reference's Segment
(reference: backend/app/services/chords/template.py Segment dataclass) and
the ChordSegment schema.

The port's copy of ``audiotabs_tpu/score/segments.py``: host code, arithmetic unchanged.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class Segment:
    start: float
    end: float
    label: str
    confidence: float = 0.0
