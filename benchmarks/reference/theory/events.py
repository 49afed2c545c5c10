"""NoteEvent: the universal note-event record.

Same fields as the reference's dataclass
(reference: backend/app/services/amt/basic_pitch.py:16-23), used by every
post-processing and scoring stage. Conversion helpers to/from a packed
numpy array keep the hot paths vectorized.

The port's copy of ``audiotabs_tpu/theory/events.py``: host code, arithmetic unchanged.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class NoteEvent:
    start_time_s: float
    end_time_s: float
    pitch_midi: int
    velocity: int = 80
    amplitude: float = 0.5

    @property
    def duration_s(self) -> float:
        return self.end_time_s - self.start_time_s


# packed array column layout
COLS = ("start", "end", "pitch", "velocity", "amplitude")


def events_to_array(events: list[NoteEvent]) -> np.ndarray:
    """[N, 5] float64 array (start, end, pitch, velocity, amplitude)."""
    if not events:
        return np.zeros((0, 5), dtype=np.float64)
    return np.array(
        [[e.start_time_s, e.end_time_s, e.pitch_midi, e.velocity, e.amplitude] for e in events],
        dtype=np.float64,
    )


def array_to_events(arr: np.ndarray) -> list[NoteEvent]:
    return [
        NoteEvent(
            start_time_s=float(r[0]),
            end_time_s=float(r[1]),
            pitch_midi=int(round(r[2])),
            velocity=int(round(r[3])),
            amplitude=float(r[4]),
        )
        for r in np.asarray(arr)
    ]
