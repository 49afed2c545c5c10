"""Harmony-only lead-sheet MusicXML.

Counterpart of audiotabs_tpu/score/lead_sheet.py (reference:
backend/app/services/musicxml/lead_sheet.py:1-145): a single part of
whole-measure rests carrying the chord symbols, the minimal MusicXML a
chord-only job produces. No path of the job writes it; it is the
reference's lead-sheet exporter.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from ..schemas import ScoreData, ScoreItem, ScoreMeasure
from ..theory.quantize import parse_time_signature
from .musicxml import export_musicxml


def export_lead_sheet_musicxml(
    out_path: Path | str,
    chords,
    *,
    tempo_bpm: float,
    beat_times: np.ndarray | None = None,
    time_signature: str = "4/4",
    key_signature_fifths: int | None = None,
    title: str = "Lead Sheet",
) -> None:
    """Chord segments → rests+harmony MusicXML."""
    sec_per_beat = 60.0 / (tempo_bpm if tempo_bpm and tempo_bpm > 0 else 120.0)
    if chords:
        end_t = max(float(c.end) for c in chords)
    elif beat_times is not None and len(beat_times):
        end_t = float(beat_times[-1])
    else:
        end_t = 4 * sec_per_beat
    num, den = parse_time_signature(time_signature)
    bar_s = num * sec_per_beat * 4 / den
    n_bars = max(1, int(np.ceil(end_t / bar_s)))

    measures = [
        ScoreMeasure(number=i + 1, items=[ScoreItem(rest=True, keys=[], duration="w")])
        for i in range(n_bars)
    ]
    score = ScoreData(grid_q=4.0, grid_kind="straight", measures=measures)
    export_musicxml(
        out_path,
        score,
        tempo_bpm=tempo_bpm,
        time_signature=time_signature,
        key_signature_fifths=key_signature_fifths,
        title=title,
        chords=list(chords),
        beat_times=beat_times,
    )
