"""Score exports: MusicXML, MIDI, CSV, LilyPond, PDF (counterpart of audiotabs_tpu/score/)."""

from .csvout import save_note_events_csv
from .midi import export_chords_midi, write_midi_from_note_events, write_midi_from_score
from .musicxml import export_musicxml
from .segments import Segment

__all__ = [
    "Segment",
    "export_musicxml",
    "write_midi_from_score",
    "write_midi_from_note_events",
    "export_chords_midi",
    "save_note_events_csv",
]
