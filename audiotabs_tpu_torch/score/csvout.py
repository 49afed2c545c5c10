"""CSV export of note events (artifact contract: out/note_events.csv).

Column layout matches the reference
(reference: backend/app/services/amt/basic_pitch.py:105-113).

The port's copy of ``audiotabs_tpu/score/csvout.py``: host code, arithmetic unchanged.
"""

from __future__ import annotations

import csv
from pathlib import Path


def save_note_events_csv(note_events, path: Path | str) -> None:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["start_time_s", "end_time_s", "pitch_midi", "velocity", "amplitude"])
        for ev in note_events:
            w.writerow(
                [
                    f"{ev.start_time_s:.6f}",
                    f"{ev.end_time_s:.6f}",
                    int(ev.pitch_midi),
                    int(ev.velocity),
                    f"{ev.amplitude:.6f}",
                ]
            )
