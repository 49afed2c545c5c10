"""The fused analysis' host→device copies of constants (windows,
filterbanks, banks, grids; ``ops/spectral.py::as_device`` and the other
sites that ``audiotabs_tpu_torch/tracing.py::uploaded`` counts): the program's
``const_uploads`` counter over the traced window, uploads a song over the
window's songs (``core/program.py``; None for a program without the tracer)."""

from core.program import count_per_song


def read(run):
    return count_per_song(run, "const_uploads")
