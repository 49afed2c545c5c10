"""What the program's own tracer kept while the window was traced.

The port's tracer (``audiotabs_tpu_torch/tracing.py``) keeps the
spans that end, and the counts made, while a ``torch.profiler`` records on
their thread; a run profiles only its window, so what it kept is the
window's. A program without the tracer keeps nothing, and each reading here
is then None. ``idle_inside`` reads a Chrome trace's spans against its
device intervals, both on the trace's clock."""

from __future__ import annotations

import importlib

from .trace import merged


def recorded() -> tuple[list, dict[str, int]] | None:
    """(spans, counts) that the program kept, or None for a program without the tracer."""
    try:
        tracing = importlib.import_module("audiotabs_tpu_torch.tracing")
    except ModuleNotFoundError:
        return None
    return tracing.recorded()


def span_ms_per_song(run, name: str, kept=None) -> float | None:
    """The summed durations of the program's spans ``name``, ms over the window's songs."""
    kept = recorded() if kept is None else kept
    spans = [s for s in kept[0] if s.name == name] if kept else []
    if not spans or not run.done:
        return None
    return sum(s.end_ns - s.start_ns for s in spans) / 1e6 / len(run.done)


def count_per_song(run, name: str, kept=None) -> float | None:
    """The program's counter ``name`` over the window, over the window's songs."""
    kept = recorded() if kept is None else kept
    n = kept[1].get(name) if kept else None
    return n / len(run.done) if n is not None and run.done else None


def idle_inside(spans: list[tuple[float, float]], device: list[tuple[str, float, float]]) -> float:
    """µs inside the union of ``spans`` (start, end) in which no device
    activity (name, start, end) ran: the spans' union less its intersection
    with the union of the device's intervals, each clipped to the other."""
    inside = merged(spans)
    busy = merged([(s, e) for _, s, e in device])
    total = sum(b - a for a, b in inside)
    overlap, j = 0.0, 0
    for a, b in inside:
        while j < len(busy) and busy[j][1] <= a:
            j += 1
        k = j
        while k < len(busy) and busy[k][0] < b:
            overlap += min(b, busy[k][1]) - max(a, busy[k][0])
            k += 1
    return total - overlap
