"""Device time by the program span that launched it, from a Chrome trace of
a traced window (``program_trace.py --keep PATH`` writes one):

    python3 benchmarks/launched_ms.py build/trace.json --songs 17

Each kernel, copy and set on the card is matched by its correlation id to
the CUDA API call that launched it (``cudaLaunchKernel``, ``cuLaunchKernel``,
``cudaMemcpyAsync``, ...), and counted in every one of the program's spans
(``audiotabs/<name>``) that encloses that call on the host's clock, so a
span holds its children's launches. The program's spans time only the
host's enqueue of asynchronous work; this places the device time that work
took. Prints one JSON object: each span name's device ms (a
song with ``--songs``) and its launches, largest first, and the device ms
whose launch lies in no program span."""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np

DEVICE = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCHERS = ("cuda_runtime", "cuda_driver")


def launched(events: list[dict]) -> dict[str, tuple[float, int]]:
    """{span name: (device µs launched inside it, launches)}, and "(none)" for launches outside every program span."""
    calls, device, spans = {}, [], {}
    for e in events:
        if e.get("ph") != "X":
            continue
        cat, start = e.get("cat"), float(e["ts"])
        corr = e.get("args", {}).get("correlation")
        if cat in LAUNCHERS and corr is not None:
            calls[corr] = start
        elif cat in DEVICE and corr is not None:
            device.append((corr, float(e.get("dur", 0.0))))
        elif cat == "user_annotation" and e["name"].startswith("audiotabs/"):
            spans.setdefault(e["name"].removeprefix("audiotabs/"), []).append((start, start + float(e.get("dur", 0.0))))
    matched = [(calls[c], d) for c, d in device if c in calls]
    t = np.array([a for a, _ in matched], dtype=float)
    dur = np.array([d for _, d in matched], dtype=float)
    out, anywhere = {}, np.zeros(len(t), dtype=bool)
    for name, intervals in spans.items():
        intervals.sort()
        starts, ends = np.array(intervals).T
        ends = np.maximum.accumulate(ends)  # nested spans of one name: the widest end so far
        i = np.searchsorted(starts, t, side="right") - 1
        inside = (i >= 0) & (t <= ends[np.maximum(i, 0)])
        anywhere |= inside
        out[name] = (float(dur[inside].sum()), int(inside.sum()))
    out["(none)"] = (float(dur[~anywhere].sum()), int((~anywhere).sum()))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trace", type=Path)
    ap.add_argument("--songs", type=int, default=1, help="divide the device ms by this many songs")
    args = ap.parse_args(argv)
    by_span = launched(json.loads(args.trace.read_text())["traceEvents"])
    print(json.dumps({name: {"device_ms": us / 1e3 / args.songs, "launches": n}
                      for name, (us, n) in sorted(by_span.items(), key=lambda kv: -kv[1][0])}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
