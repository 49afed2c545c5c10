"""The host tail's tab optimizer (``tab/optimizer.py::optimize_tab_positions_for_events``,
in the ``quantize`` stage): the durations of the program's ``quantize/tab``
spans kept over the traced window, summed, ms over the window's songs
(``core/program.py``; None for a program without the tracer)."""

from core.program import span_ms_per_song


def read(run):
    return span_ms_per_song(run, "quantize/tab")
