"""htdemucs' model FLOPs of a song: ``core/flops.py::htdemucs_song`` at the
configuration's ``nets.htdemucs`` (``segment``, ``stride``, ``shifts`` and
``cross_layers`` included)."""

from core.flops import htdemucs_song


def song(widths: dict, n: int) -> int:
    """A song of ``n`` samples at the analysis rate (22.05 kHz)."""
    return htdemucs_song(widths, n)
