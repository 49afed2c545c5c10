"""The host tail's strum detector (``accompaniment/strum.py::detect_strum_onsets``,
in the ``mode`` stage): the durations of the program's ``mode/strum`` spans
kept over the traced window, summed, ms over the window's songs
(``core/program.py``; None for a program without the tracer)."""

from core.program import span_ms_per_song


def read(run):
    return span_ms_per_song(run, "mode/strum")
