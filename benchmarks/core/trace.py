"""The device trace of a window: ``torch.profiler`` (CUPTI) over the whole
window, its Chrome trace read back for the device's activities (kernels,
copies, sets) and the benchmark's ``record_function`` spans, which share its
clock."""

from __future__ import annotations

import collections
import dataclasses
import json
from pathlib import Path

import numpy as np

from .drive import SPANS


@dataclasses.dataclass
class Trace:
    device: list[tuple[str, float, float]]  # (name, start µs, end µs)
    spans: list[tuple[str, float, float]]  # the benchmark's spans, (name, start µs, end µs)
    window: tuple[float, float]  # the "window" span on the trace's clock, µs


def profiler():
    from torch.profiler import ProfilerActivity, profile

    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], record_shapes=False, with_stack=False,
                   profile_memory=False)


def read(prof, path: Path) -> Trace:
    prof.export_chrome_trace(str(path))
    try:
        events = json.loads(path.read_text())["traceEvents"]
    finally:
        path.unlink(missing_ok=True)
    device, spans, window = [], [], None
    for e in events:
        if e.get("ph") != "X":
            continue
        start, end = float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0))
        if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"):
            device.append((e["name"], start, end))
        elif e.get("cat") == "user_annotation":
            if e["name"] == "window":
                window = (start, end)
            elif e["name"] in SPANS:
                spans.append((e["name"], start, end))
    if window is None:
        raise RuntimeError("the trace holds no window span")
    return Trace(device, spans, window)


def merged(intervals: list[tuple[float, float]]) -> list[tuple[float, float]]:
    out: list[list[float]] = []
    for start, end in sorted(intervals):
        if out and start <= out[-1][1]:
            out[-1][1] = max(out[-1][1], end)
        else:
            out.append([start, end])
    return [(a, b) for a, b in out]


def busy_s(trace: Trace) -> float:
    """Seconds in the window in which at least one device activity ran (the union of their intervals)."""
    lo, hi = trace.window
    return sum(min(b, hi) - max(a, lo) for a, b in merged([(s, e) for _, s, e in trace.device]) if b > lo and a < hi) / 1e6


def breakdown(trace: Trace, top: int = 10) -> dict:
    """The device operations that took most time, and the window's idle time
    by what the host was doing: the innermost benchmark span around the
    middle of each gap (``program`` where none is)."""
    by_name: dict[str, float] = collections.defaultdict(float)
    for name, s, e in trace.device:
        by_name[name] += (e - s) / 1e6
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    lo, hi = trace.window
    busy = merged([(max(s, lo), min(e, hi)) for _, s, e in trace.device if e > lo and s < hi])
    edges = np.array([lo] + [x for iv in busy for x in iv] + [hi])
    starts, ends = edges[::2], edges[1::2]
    mids = (starts + ends) / 2
    label = np.full(len(mids), -1)
    names = sorted({sp[0] for sp in trace.spans})
    for name, s, e in sorted(trace.spans, key=lambda sp: sp[1]):  # a later start is further in
        label[(mids >= s) & (mids <= e)] = names.index(name)
    lengths = np.clip(ends - starts, 0, None) / 1e6
    idle = {"program": float(lengths[label < 0].sum())} | {n: float(lengths[label == i].sum()) for i, n in enumerate(names)}
    gaps = sorted(((n, v) for n, v in idle.items() if v > 0), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[n, v] for n, v in ops], "idle_gaps": [[n, v] for n, v in gaps]}
