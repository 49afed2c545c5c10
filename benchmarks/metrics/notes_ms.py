"""The host tail's note decoding (``models/basicpitch.py::notes_from_posteriors``, in the
``transcription`` stage): the durations of the program's ``transcription/notes`` spans kept
over the traced window, summed, ms over the window's songs (``core/program.py``; None for a
program without the span). The program's ``note_events`` and ``note_seeds`` counters give the
events and melodia seeds behind them."""

from core.program import span_ms_per_song


def read(run):
    return span_ms_per_song(run, "transcription/notes")
