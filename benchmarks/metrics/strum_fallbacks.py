"""The host tail's strum detector: the segments whose device envelope
(``accompaniment/strum.py::strum_flux_batch``) left a decision inside the
guard, so their host envelope was computed again. The program's
``strum_fallbacks`` counter over the traced window, a song over the window's
songs (``core/program.py``; None for a program without the counter)."""

from core.program import count_per_song


def read(run):
    return count_per_song(run, "strum_fallbacks")
