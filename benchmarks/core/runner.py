"""One run of one cell: set-up, the measured window, the trace's readings,
the check, and the result line's object."""

from __future__ import annotations

import contextlib
import dataclasses
import math
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from . import check, flops, songs
from .cells import Cell, reader
from .configured import configured
from .drive import Hooks, Loop

FORBIDDEN = ("jax", "jaxlib", "flax", "audiotabs_tpu")


@dataclasses.dataclass
class RunData:
    """What a per-layer metric's reader reads."""

    done: list  # drive.Done of every song of the window
    window_s: float
    layer_ms: dict  # {"separation" | "fused": (device ms, songs)}
    launches: dict  # {"median": [numel], "dbn": [(shape, grid)]}
    device: list  # (name, start µs, end µs) of every device activity
    busy_s: float
    song_flops: float  # model FLOPs of the window's songs
    config: dict  # the cell's configuration: the widths a reader reads
    separation: tuple | None  # (net, its song(widths, n)): flops.separation_net of the configuration


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def card() -> dict:
    name = torch.cuda.get_device_name(0)
    try:
        limit = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader", "-i", "0"],
                               capture_output=True, text=True, timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        limit = "unknown"
    return {"kind": name, "power_limit": limit or "unknown"}


def bytes_written() -> int | None:
    try:
        for line in Path("/proc/self/io").read_text().splitlines():
            if line.startswith("wchar:"):
                return int(line.split()[1])
    except OSError:
        pass
    return None


def sample(cell: Cell, seed: int) -> set[int]:
    """The songs the check compares, drawn from the seed; the longest song is always one of them."""
    n, k = int(cell.traffic["songs"]), int(cell.traffic["checked"])
    plan = songs.song_plan(cell.traffic, seed)
    longest = max(range(n), key=lambda i: plan[i][0])
    rest = [i for i in np.random.default_rng([seed, 2]).permutation(n) if i != longest]
    return {longest, *(int(i) for i in rest[: k - 1])}


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device: str, t0: float) -> tuple[dict, list[str]]:
    """→ (the result line's object, the lines for standard error)."""
    from audiotabs_tpu_torch.config import Settings

    separation = flops.separation_net(cell.config, cell.root)  # a net that cannot be counted fails here, before any song is made
    dev = torch.device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    overrides = cell.config.get("settings", {})
    settings = Settings(**overrides)
    tmp = Path(tempfile.mkdtemp(prefix="audiotabs-bench-"))
    config_set_up = contextlib.ExitStack()
    try:
        made = config_set_up.enter_context(configured(cell.config, cell.root, tmp, dev))
        (tmp / "songs").mkdir()
        t_songs = time.perf_counter()
        song_list = songs.make_songs(cell.traffic, seed, tmp / "songs", dev)
        t_songs = time.perf_counter() - t_songs
        hooks = Hooks(trace and dev.type == "cuda")
        try:
            loop = Loop(cell.traffic["loop"], song_list, settings, hooks, tmp / "jobs", int(cell.traffic.get("batch", 1)),
                        None if dev.type == "cuda" else dev)
            t_warm = time.perf_counter()
            loop.warm_up()
            if dev.type == "cuda":
                torch.cuda.synchronize()
            setup_s = time.perf_counter() - t0
            t_warm = time.perf_counter() - t_warm
            hooks.want = sample(cell, seed)
            prof = None
            if hooks.trace:
                from .trace import profiler

                prof = profiler()
                prof.__enter__()
            done, window_s = loop.window(seconds)
            layer_ms, tr, t_trace = {}, None, 0.0
            if prof is not None:
                prof.__exit__(None, None, None)
                from . import trace as trace_mod

                layer_ms = hooks.layer_ms()
                t_trace = time.perf_counter()
                tr = trace_mod.read(prof, tmp / "trace.json")
                t_trace = time.perf_counter() - t_trace
            peak = int(torch.cuda.max_memory_allocated(dev)) if dev.type == "cuda" else 0
            prog = {i: {"stems": hooks.stems.get(i), "feats": hooks.feats[i], **loop.results[i]}
                    for i in sorted(hooks.want | set(loop.results)) if i in hooks.feats and i in loop.results}
            launches = hooks.launches
        finally:
            hooks.close()

        failed = sum(d.error is not None for d in done)
        audio = sum(d.song.seconds for d in done)
        metrics = {} if trace else end_to_end(cell, done, window_s, setup_s)
        device_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                       "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
                       "count": 1, "memory_peak_bytes": peak}
        breakdown = None
        if tr is not None:
            from . import trace as trace_mod

            busy = trace_mod.busy_s(tr)
            device_info.update(busy_s=busy, window_s=window_s)
            breakdown = trace_mod.breakdown(tr)
            data = RunData(done, window_s, layer_ms, launches, tr.device, busy,
                           sum(flops.song_flops(cell.config, d.song.seconds, separation) for d in done), cell.config,
                           separation)
            for m in cell.per_layer:
                value = reader(m["name"], cell.root)(data)
                if value is not None:
                    metrics[m["name"]] = {"value": value, "unit": m["unit"]}

        # the check, after the window, the peak and the program's state
        del hooks
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        t_check = time.perf_counter()
        numbers, tally = compare_songs(cell, song_list, prog, dev, tmp)
        t_check = time.perf_counter() - t_check
        limits = cell.config["limits"]
        within = {k: v <= limits[k] for k, v in numbers.items()}
        correct = bool(prog) and failed == 0 and all(within.values()) and set(numbers) == set(cell.config["limits"])
    finally:
        config_set_up.close()
        shutil.rmtree(tmp, ignore_errors=True)

    # a number that is not finite (a missing output, a NaN) prints as null; the run is not correct
    compared = {k: {"value": numbers[k] if math.isfinite(numbers.get(k, math.nan)) else None, "limit": limits[k]}
                for k in limits}
    compared["songs_compared"] = {"value": len(prog), "limit": 1}
    compared["failed"] = {"value": failed, "limit": 0}
    line = {"correct": correct, "attempted": len(done), "failed": failed, "metrics": metrics, "device": device_info}
    if breakdown is not None:
        line["breakdown"] = breakdown
    line["compared"] = compared
    info = card() if dev.type == "cuda" else {"kind": "cpu", "power_limit": "none"}
    err = [f"run: set-up {setup_s:.3f} s (songs {t_songs:.3f} s, warm-up {t_warm:.3f} s), window {window_s:.3f} s, trace read {t_trace:.3f} s, check {t_check:.3f} s",
           f"run: {len(done)} songs, {audio:.1f} s of audio in {window_s:.3f} s; bytes written {bytes_written()}; "
           f"card {info['kind']}, power limit {info['power_limit']}", *made]
    errors = sorted({d.error for d in done if d.error is not None})
    err += [f"failed: {e}" for e in errors[:5]]
    err.append(f"check: the reference's tail ran on its own features for {tally[0]} of {tally[1]} songs "
               "(on the program's where they differ)")
    err += [f"compared {k}: {v['value']} limit {v['limit']}" for k, v in compared.items()]
    return line, err


def end_to_end(cell: Cell, done: list, window_s: float, setup_s: float) -> dict:
    """The cell's end-to-end metrics: every song completed in the window over
    the window's seconds, the 90th percentile of every song's wall seconds
    (a song's call: the batch's, in a batch), and the set-up seconds."""
    values = {"audio_s_per_s": sum(d.song.seconds for d in done) / window_s, "setup_s": setup_s}
    walls = [d.wall_s for d in done]
    if len(walls) >= 2:
        values["song_p90_s"] = statistics.quantiles(walls, n=10, method="inclusive")[-1]
    return {m["name"]: {"value": values[m["name"]], "unit": m["unit"]} for m in cell.end_to_end if m["name"] in values}


def compare_songs(cell: Cell, song_list: list, prog: dict, dev: torch.device, tmp: Path) -> tuple[dict[str, float], list[int]]:
    """→ (the worst of each number over the songs compared, the reference's tally of tails)."""
    ref = check.Reference(cell.config.get("settings", {}), dev, tmp=tmp)
    readings = []
    if cell.traffic["loop"] == "single":
        for i, p in prog.items():
            r, tail = ref.single(song_list[i].path, f"song{i:02d}", p["feats"])
            readings.append(check.compare(p, r, tail))
    else:
        got = ref.batch([s.path for s in song_list], sorted(prog), {i: p["feats"] for i, p in prog.items()})
        for i, p in prog.items():
            r, tail = got[i]
            readings.append(check.compare(p, r, tail))
    return {k: v for k, v in check.worst(readings).items() if k in cell.config["limits"]}, ref.tally
