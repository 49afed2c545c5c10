"""The program's own spans and counters over one traced window of a cell,
read from the profiler's Chrome trace (the trace's clock) and from what the
program's tracer kept.

    python3 benchmarks/program_trace.py --workload mix-clip30 --seed 7 --seconds 51 [--keep build/trace.json]

Runs the cell as ``run.py --trace 1`` does (its songs, a cold and a warm
call, then the window under ``torch.profiler`` with the benchmark's spans)
and prints one JSON object: the window's songs and the card; the readings of
``tab_ms``, ``strum_ms``, ``const_uploads`` and ``fused_idle_ms`` (the time
inside the program's ``audiotabs/analysis`` spans with no device activity,
ms a song); the window's idle seconds by the innermost program span around
each gap, and the idle ms a song inside each span name; each program span's
count and ms a song; the pageable host→device copies of the trace beside
the counters, and by innermost span; how much of each request its top-level
spans cover, and the gaps between them; the program spans that cross a
benchmark span; how each copy on the device sits inside its runtime call
(the skew between the trace's host and device clocks); the key sets of
``profile.json``; and a span's cost with the profiler off and on. No check
against the reference is made."""

from __future__ import annotations

import argparse
import collections
import contextlib
import json
import shutil
import statistics
import sys
import tempfile
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE), str(HERE.parent)]

HTOD = "Memcpy HtoD (Pageable"  # the start of the name; torch 2.11 adds " -> Device)"


def read_chrome(path: Path):
    """→ (device activities, the program's spans, the benchmark's spans, the window), (name, start µs, end µs),
    the bytes of the pageable host→device copies, and each copy's (device start − its runtime call's start,
    the call's end − device end), µs, matched by correlation id."""
    from core.drive import SPANS

    device, program, bench, window, htod_bytes = [], [], [], None, 0
    calls, copies = {}, {}
    for e in json.loads(path.read_text())["traceEvents"]:
        if e.get("ph") != "X":
            continue
        start, end = float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0))
        corr = e.get("args", {}).get("correlation")
        if e.get("cat") == "cuda_runtime" and "Memcpy" in e["name"]:
            calls[corr] = (start, end)
        if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"):
            device.append((e["name"], start, end))
            if e.get("cat") == "gpu_memcpy":
                copies[corr] = (e["name"], start, end)
            if e["name"].startswith(HTOD):
                htod_bytes += int(e.get("args", {}).get("bytes", 0))
        elif e.get("cat") == "user_annotation":
            if e["name"] == "window":
                window = (start, end)
            elif e["name"].startswith("audiotabs/"):
                program.append((e["name"].removeprefix("audiotabs/"), start, end))
            elif e["name"] in SPANS:
                bench.append((e["name"], start, end))
    lo, hi = window
    inside = lambda iv: iv[1] > lo and iv[2] < hi  # noqa: E731
    skew = {}
    for corr, (name, s, e) in copies.items():
        if corr in calls and lo < s < hi:
            skew.setdefault(name, []).append((s - calls[corr][0], calls[corr][1] - e))
    return [d for d in device if inside(d)], [p for p in program if inside(p)], bench, window, htod_bytes, skew


def innermost(spans, times: list[float]) -> list[str]:
    """The name of the innermost of ``spans`` (the latest start) around each of ``times``, else "none"."""
    import numpy as np

    t = np.asarray(times, dtype=float)
    label = np.full(len(t), -1)
    for i in sorted(range(len(spans)), key=lambda i: spans[i][1]):
        label[(t >= spans[i][1]) & (t <= spans[i][2])] = i
    return [spans[i][0] if i >= 0 else "none" for i in label]


def crossings(program, bench) -> list:
    """Pairs of a program span and a benchmark span that overlap with neither inside the other."""
    out = []
    for p in program:
        for b in bench:
            if p[1] < b[2] and b[1] < p[2] and not (b[1] <= p[1] and p[2] <= b[2]) and not (p[1] <= b[1] and b[2] <= p[2]):
                out.append((p[0], b[0], p[1], p[2], b[1], b[2]))
    return out


def span_cost_ns(n: int) -> dict[str, float]:
    from torch.profiler import ProfilerActivity, profile

    from audiotabs_tpu_torch.tracing import span

    def per_span():
        t0 = time.perf_counter_ns()
        for _ in range(n):
            with span("cost"):
                pass
        return (time.perf_counter_ns() - t0) / n

    off = per_span()
    with profile(activities=[ProfilerActivity.CPU]):
        on = per_span()
    return {"off": off, "on": on}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--keep", type=Path, help="where to keep the Chrome trace")
    args = ap.parse_args(argv)

    import torch

    from core import program, songs
    from core.cells import load_cell
    from core.configured import configured
    from core.drive import Hooks, Loop
    from core.runner import card
    from core.trace import Trace, breakdown, busy_s, profiler

    if not torch.cuda.is_available():
        print("program_trace: no CUDA device; no result", file=sys.stderr)
        return 3
    from audiotabs_tpu_torch.config import Settings

    cell = load_cell(args.workload)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    tmp = Path(tempfile.mkdtemp(prefix="audiotabs-trace-"))
    config_set_up = contextlib.ExitStack()
    try:
        config_set_up.enter_context(configured(cell.config, cell.root, tmp, torch.device("cuda")))
        (tmp / "songs").mkdir()
        song_list = songs.make_songs(cell.traffic, args.seed, tmp / "songs", torch.device("cuda"))
        hooks = Hooks(True)
        try:
            loop = Loop(cell.traffic["loop"], song_list, Settings(**cell.config.get("settings", {})), hooks, tmp / "jobs",
                        int(cell.traffic.get("batch", 1)))
            loop.warm_up()
            torch.cuda.synchronize()
            kept_before = program.recorded()
            with profiler() as prof:
                done, window_s = loop.window(args.seconds)
            kept = program.recorded()
        finally:
            hooks.close()
        path = args.keep or tmp / "trace.json"
        path.parent.mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(path))
        device, spans, bench, window, htod_bytes, skew = read_chrome(path)
    finally:
        config_set_up.close()
        shutil.rmtree(tmp, ignore_errors=True)

    # what the tracer kept in the window alone
    n0 = len(kept_before[0])
    counts0 = kept_before[1]
    kept = (kept[0][n0:], {k: v - counts0.get(k, 0) for k, v in kept[1].items()})
    n = len(done)
    run = type("Run", (), {"done": done})()
    trace = Trace(device, spans, window)
    idle = breakdown(trace, top=40)["idle_gaps"]
    analysis = [(s, e) for name, s, e in spans if name == "analysis"]
    by_name = collections.defaultdict(list)
    for name, s, e in spans:
        by_name[name].append(e - s)
    htod_by_span = collections.Counter(innermost(spans, [(s + e) / 2 for name, s, e in device if name.startswith(HTOD)]))
    coverage, gaps = [], collections.Counter()
    children = collections.defaultdict(list)
    for c in kept[0]:
        if c.parent is not None and c.parent.name == "request":
            children[id(c.parent)].append(c)
    for req in (s for s in kept[0] if s.name == "request"):
        top = sorted(children[id(req)], key=lambda c: c.start_ns)
        coverage.append(sum(c.end_ns - c.start_ns for c in top) / (req.end_ns - req.start_ns))
        edges = [("start", req.start_ns, req.start_ns)] + [(c.name, c.start_ns, c.end_ns) for c in top] + [("end", req.end_ns, req.end_ns)]
        for (a, _, a_end), (b, b_start, _) in zip(edges, edges[1:]):
            gaps[f"{a} > {b}"] += (b_start - a_end) / 1e6 / n
    crossed = crossings(spans, bench)
    profiles = [d.profile for d in done if d.profile is not None]
    key_sets = sorted({tuple(p) for p in profiles})
    out = {
        "workload": args.workload, "seed": args.seed, "card": card(), "songs": n, "window_s": window_s,
        "busy_s": busy_s(trace), "audio_s": sum(d.song.seconds for d in done),
        "failed": sum(d.error is not None for d in done),
        "metrics": {
            "tab_ms": program.span_ms_per_song(run, "quantize/tab", kept),
            "strum_ms": program.span_ms_per_song(run, "mode/strum", kept),
            "const_uploads": program.count_per_song(run, "const_uploads", kept),
            "fused_idle_ms": program.idle_inside(analysis, device) / 1e3 / n if analysis and n else None,
            "decode_ms": 1e3 * statistics.fmean(p["decode"] for p in profiles) if profiles else None,
            "host_tail_ms": 1e3 * statistics.fmean(sum(v for k, v in p.items() if k not in ("decode", "separation", "analysis"))
                                                   for p in profiles) if profiles else None,
        },
        "idle_by_span_s": idle,
        "idle_inside_ms_per_song": {k: program.idle_inside([(s, e) for name, s, e in spans if name == k], device) / 1e3 / n
                                    for k in by_name},
        "spans_ms_per_song": {k: [len(v), sum(v) / 1e3 / n] for k, v in sorted(by_name.items(), key=lambda kv: -sum(kv[1]))},
        "uploads": {"pageable_htod": sum(name.startswith(HTOD) for name, *_ in device), "pageable_htod_bytes": htod_bytes,
                    "counted": {k: v for k, v in kept[1].items() if "upload" in k},
                    "htod_by_innermost_span": dict(htod_by_span.most_common())},
        "request_coverage": {"min": min(coverage), "median": statistics.median(coverage), "max": max(coverage),
                             "requests": len(coverage), "share_at_least_98": sum(c >= 0.98 for c in coverage) / len(coverage),
                             "gaps_ms_per_song": dict(gaps.most_common(8))} if coverage else None,
        "crossings": {"count": len(crossed), "first": crossed[:5]},
        # a copy on the device should start after its runtime call starts and, when synchronous, end before it
        # returns: a negative least margin is the skew between the trace's host and device clocks
        "copy_margins_us": {k: {"copies": len(v), "least_start": min(a for a, _ in v), "least_end": min(b for _, b in v),
                                "median_start": statistics.median(a for a, _ in v),
                                "median_end": statistics.median(b for _, b in v)} for k, v in skew.items()},
        "profile_keys": [list(k) for k in key_sets],
        "span_cost_ns": span_cost_ns(20000),
    }
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
