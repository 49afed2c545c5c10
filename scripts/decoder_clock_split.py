"""Clocks per part of a frame of the decoder kernels with ``SPLIT`` marks, on the card.

    python3 scripts/decoder_clock_split.py [KERNEL ...]

Builds the marked kernels again (csrc/dbn_viterbi.cu, banded_viterbi.cu,
dense_viterbi.cu, onset_wait.cu, salience_envelope.cu and
constant_switch_viterbi.cu, or the ones named), into build/clock_split/,
with their ``SPLIT`` marks defined: at each mark every thread reads
``clock64()``, and one thread adds the clocks since the previous mark to the
counter of that mark's part: thread 0 of block 0 (``SPLIT_START``), or the
thread a kernel names (``SPLIT_START_IF``, and ``SPLIT_FOLLOW`` from a point
on, as the envelope's tail block does); ``SPLIT_SKIP`` restarts the count
without adding (time that a called function's own marks counted). Each
kernel's op is called once on random inputs at each of its shapes
(``CASES``), and its one launch (``_build.launch``, with the arguments the
op prepared) is then made again on this build (the cached launcher swapped
for the marked one), once to warm up and once counted: the DBN at [1, 3007]
(the 30 s bucket; on the shipped tempo grid, and on the grids of
``DBN_GRIDS``, which take its general layout), the banded Viterbi at [20, 130, 241] (the content windows of one song, band 25),
the dense Viterbi at [1, 301, 25] (the CRF of the 30 s bucket) and
[1, 1801, 25] (a 180 s song), the onset rule at [20, 130] (the content
windows), [1, 1292] (the calibration) and [1, 7752] (a 180 s song's
calibration), the salience envelope at [1, 88, 2584] (the 30 s bucket),
[1, 88, 15504] (a 180 s song) and [4, 88, 2584] (a batch chunk), the
constant-switch Viterbi at [1, 49, 301] (majmin7 at the 30 s bucket),
[1, 49, 1801] (a 180 s song) and [4, 49, 301] (a batch chunk). Prints, for
each part, the clocks per frame (parts inside the frame loop) or in all
(parts after it), the marked launch's time by CUDA events, the time of the
port's own (unmarked) build on the same inputs (events, a spin kernel
ahead, the median of 20) and the card's name, power limit and SM clock.
What each part holds is written beside its mark in the source. Each mark
costs tens of clocks (a clock read and an add to device memory) and
serialises the instructions around it, so the marked build is slower than
the one the port runs; its parts are for comparing shares, and the port's
times come from chip_smoke.py.
"""

from __future__ import annotations

import ctypes
import importlib
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

from audiotabs_tpu_torch import _build  # noqa: E402

OUT = REPO / "build" / "clock_split"
N_PARTS = 8
WRAPPER = """#include <cuda_runtime.h>
__device__ unsigned long long g_split[{n}];
#define SPLIT_START_IF(cond) long long split_t0 = clock64(); bool split_me = (cond)
#define SPLIT_START SPLIT_START_IF(blockIdx.x == 0 && blockIdx.y == 0 && threadIdx.x == 0)
#define SPLIT_FOLLOW(cond) split_me = (cond)
#define SPLIT_SKIP split_t0 = clock64()
#define SPLIT(part)                                                   \\
  do {{                                                               \\
    const long long split_t1 = clock64();                             \\
    if (split_me) g_split[part] += split_t1 - split_t0;               \\
    split_t0 = split_t1;                                              \\
  }} while (0)
#include "{source}"
extern "C" int split_read(unsigned long long* out) {{
  return static_cast<int>(cudaMemcpyFromSymbol(out, g_split, sizeof(g_split)));
}}
extern "C" int split_reset() {{
  unsigned long long zero[{n}] = {{0}};
  return static_cast<int>(cudaMemcpyToSymbol(g_split, zero, sizeof(zero)));
}}
"""
# name → (module, the op that launches the kernel)
KERNELS = {
    "dbn_viterbi": ("audiotabs_tpu_torch.decode.dbn_beats", "_dbn_forward"),
    "banded_viterbi": ("audiotabs_tpu_torch.ops.pyin", "_banded_viterbi"),
    "dense_viterbi": ("audiotabs_tpu_torch.decode.viterbi", "viterbi_log_dense"),
    "onset_wait": ("audiotabs_tpu_torch.ops.onset", "_wait"),
    "salience_envelope": ("audiotabs_tpu_torch.models.basicpitch", "salience_envelope"),
    "constant_switch_viterbi": ("audiotabs_tpu_torch.decode.viterbi", "viterbi_constant_switch"),
}
# the shapes each kernel is split at
CASES = {
    "dbn_viterbi": [(1, 3007)],
    "banded_viterbi": [(20, 130, 241)],
    "dense_viterbi": [(1, 301, 25), (1, 1801, 25)],
    "onset_wait": [(20, 130), (1, 1292), (1, 7752)],
    "salience_envelope": [(1, 88, 2584), (1, 88, 15504), (4, 88, 2584)],
    "constant_switch_viterbi": [(1, 49, 301), (1, 49, 1801), (4, 49, 301)],
}
# the DBN also at tempo grids (min_bpm, max_bpm, fps) past its register
# layouts, which take its general layout (the shipped grid is 55-215 BPM at 100 fps)
DBN_GRIDS = [(30.0, 215.0, 100), (20.0, 300.0, 100), (10.0, 400.0, 100)]
SPIN_CYCLES = 2_000_000  # about 1 ms of a spin kernel ahead of each timed launch, as chip_smoke.py's


def build_marked(name: str) -> ctypes.CDLL:
    OUT.mkdir(parents=True, exist_ok=True)
    wrapper = OUT / f"{name}_split.cu"
    wrapper.write_text(WRAPPER.format(n=N_PARTS, source=_build.PACKAGE_DIR / "csrc" / f"{name}.cu"))
    lib = OUT / f"{name}_split.so"
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(wrapper)], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for the marked {name}.cu:\n{proc.stdout}\n{proc.stderr}")
    print(f"ptxas {name} (marked): " + " | ".join(l.strip() for l in (proc.stdout + proc.stderr).splitlines() if "Used" in l or "spill" in l))
    return ctypes.CDLL(str(lib))


def inputs(name: str, shape: tuple, grid: tuple = (55.0, 215.0, 100)) -> tuple:
    """The op's arguments at ``shape`` on the card (the DBN's at the
    tempo grid ``grid``), and the frames of its frame loop."""
    rng = np.random.default_rng(0)
    if name == "dbn_viterbi":
        act = torch.from_numpy(rng.random(shape).astype(np.float32)).cuda()
        return (act, grid[2], grid[0], grid[1], 100.0, 16), shape[-1] - 1
    if name == "onset_wait":
        # the calibration's rule: candidates at about a tenth of the frames, wait 4
        return (torch.from_numpy(rng.random(shape) < 0.1).cuda(), 4), shape[-1]
    if name == "salience_envelope":
        from audiotabs_tpu_torch.models.basicpitch import ENVELOPE_DECAY, ENVELOPE_STRIDE

        return (torch.from_numpy(rng.random(shape).astype(np.float32)).cuda(), ENVELOPE_STRIDE, ENVELOPE_DECAY), shape[-1]
    if name == "constant_switch_viterbi":
        em = rng.random(shape).astype(np.float32) ** 4 + np.float32(1e-3)  # chord-state probabilities, as chip_smoke.py's
        return (torch.from_numpy(em / em.sum(1, keepdims=True)).cuda(), 2.5), shape[-1] - 1
    if name == "dense_viterbi":
        em = rng.random(shape).astype(np.float32) + np.float32(0.01)
        trans = np.full(shape[-1:] * 2, np.log(0.02 / (shape[-1] - 1)), np.float32)
        np.fill_diagonal(trans, np.log(0.98))  # the CRF's self-transition prior
        log_em = torch.log_softmax(torch.from_numpy(np.log(em)).cuda(), dim=-1)
        init = torch.full(shape[-1:], -float(np.log(shape[-1])), device="cuda")
        return (log_em, torch.from_numpy(trans).cuda(), init), shape[-2] - 1
    R, T, n_bins = shape
    obs = rng.random(shape).astype(np.float32)
    obs /= obs.sum(-1, keepdims=True) * rng.uniform(1.0, 3.0, (R, T, 1))
    voiced = np.clip(obs.sum(-1), 0.0, 1.0)
    log_u = np.log(np.maximum(1.0 - voiced, np.float32(1e-10)) / n_bins).astype(np.float32)[..., None]
    log_v = torch.from_numpy(np.log(obs + np.float32(1e-10))).cuda()
    return (log_v, torch.from_numpy(log_u).cuda().expand(*shape), 25, 0.01), T


def launch_of(op, args: tuple):
    """``launch()``, the one ``_build.launch`` that ``op(*args)`` makes, on the
    arguments that call prepared, and the kernel's C symbol and argtypes."""
    calls, real = [], _build.launch

    def keep(*a, **kw):
        calls.append((a, kw))
        return real(*a, **kw)

    _build.launch = keep
    try:
        op(*args)
    finally:
        _build.launch = real
    (a, kw), = calls
    return lambda: _build.launch(*a, **kw), a[1], a[2]


def split(name: str, lib: ctypes.CDLL, shape: tuple, *grid) -> dict:
    module, op = KERNELS[name]
    args, frames = inputs(name, shape, *grid)
    launch, symbol, argtypes = launch_of(getattr(importlib.import_module(module), op), args)
    fn = getattr(lib, symbol)
    fn.argtypes, fn.restype = argtypes, ctypes.c_int
    _build._FUNCS[(name, symbol)] = fn  # the launch now runs the marked build
    launch()
    torch.cuda.synchronize()
    if lib.split_reset() != 0:
        raise RuntimeError("cudaMemcpyToSymbol failed")
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    launch()
    end.record()
    end.synchronize()
    counts = (ctypes.c_ulonglong * N_PARTS)()
    if lib.split_read(counts) != 0:
        raise RuntimeError("cudaMemcpyFromSymbol failed")
    _build._FUNCS.pop((name, symbol))
    parts = {i: int(c) for i, c in enumerate(counts) if c}
    ms = start.elapsed_time(end)
    total = sum(parts.values())
    # the port's own build (no marks): the median of 20 launches by events, a spin kernel ahead of each
    launch()
    times = []
    for _ in range(20):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CYCLES)
        start.record()
        launch()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return {
        "shape": list(shape), "frames": frames, "ms": ms, "port_ms": float(np.median(times)), "us_per_frame": ms * 1e3 / frames,
        "clocks": parts, "clocks_per_frame": {i: c / frames for i, c in parts.items()},
        "clocks_total": total, "mhz_implied": total / (ms * 1e3),
    }


def main() -> int:
    if not torch.cuda.is_available():
        print("decoder_clock_split: no CUDA device is available", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,clocks.max.sm", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    print(smi.stdout.strip())
    names = sys.argv[1:] or list(KERNELS)
    unknown = set(names) - set(KERNELS)
    if unknown:
        print(f"decoder_clock_split: no marked kernel named {sorted(unknown)}; there are {list(KERNELS)}", file=sys.stderr)
        return 2
    out = {}
    for name in names:
        lib = build_marked(name)
        for shape in CASES[name]:
            out[f"{name} {list(shape)}"] = split(name, lib, shape)
        if name == "dbn_viterbi":
            for grid in DBN_GRIDS:
                out[f"{name} {list(CASES[name][0])} at {grid[0]:g}-{grid[1]:g} bpm, {grid[2]} fps"] = split(name, lib, CASES[name][0], grid)
    for label, row in out.items():
        per = ", ".join(f"part {i}: {c:.1f}" for i, c in row["clocks_per_frame"].items())
        print(f"{label}: {row['ms']:.4f} ms by events ({row['us_per_frame']:.3f} us per frame over {row['frames']} frames; "
              f"the port's unmarked build {row['port_ms']:.4f} ms, a spin kernel ahead); "
              f"thread 0's clocks per frame by part: {per}; {row['clocks_total']} clocks in all ({row['mhz_implied']:.0f} MHz implied)")
    print(json.dumps({"clock_split": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
