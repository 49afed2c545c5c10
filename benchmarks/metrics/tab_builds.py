"""The host tail's tab optimizer (``tab/optimizer.py::optimize_tab_positions_for_events``): the
candidate sets it built, one per distinct (pitches, label) of a call, from the program's
``tab_builds`` counter over the traced window, builds a song over the window's songs
(``core/program.py``; None for a program without the counter). Its ``tab_events`` counter gives
the events behind them."""

from core.program import count_per_song


def read(run):
    return count_per_song(run, "tab_builds")
