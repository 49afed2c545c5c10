"""Separation's windows through the net (``models/htdemucs.py::separate_program``,
every shift's windows): the program's ``separation_windows`` counter over the
traced window, windows a song over the window's songs (``core/program.py``;
None for a program without the counter)."""

from core.program import count_per_song


def read(run):
    return count_per_song(run, "separation_windows")
