"""Separation (``models/htdemucs.py::separate_program``): device ms a song
between CUDA events recorded around each call, summed over the window."""


def read(run):
    ms, songs = run.layer_ms.get("separation", (0.0, 0))
    return ms / songs if songs else None
