"""Separation's share of the card's float32 peak: the separation net's FLOPs
of the window's songs (the ``song(widths, n)`` of ``benchmarks/nets/<net>.py``
for the net that the cell's configuration names, ``RunData.separation``, at
its ``nets.<net>``, over each song's true length) over separation's device
seconds (the CUDA events that ``separation_ms`` reads) and 67 TFLOP/s, %.
The FLOPs are read from the shapes, the same work whatever implements it.
None where the configuration does not separate or no separation was timed."""

from core.flops import samples
from core.work import F32_PEAK_FLOPS


def read(run):
    ms, songs = run.layer_ms.get("separation", (0.0, 0))
    if not songs or ms <= 0 or run.separation is None:
        return None
    net, song = run.separation
    work = sum(song(run.config["nets"][net], samples(d.song.seconds)) for d in run.done)
    return 100.0 * work / (ms / 1e3) / F32_PEAK_FLOPS
