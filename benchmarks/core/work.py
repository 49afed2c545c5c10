"""The yardstick of the kernel metrics: the H100's published peaks and the
operations and bytes a kernel's launch needs, from its shapes.

Peaks (NVIDIA H100 SXM data sheet, dense): 67 TFLOP/s float32 outside the
tensor cores, 3.35 TB/s of HBM3. Issue rates (CUDA C++ Programming Guide,
compute capability 9.0): 128 float32 adds and 64 min/max a clock on each of
132 SMs, at the published boost clock of 1,980 MHz, fixed here and never
read from the card."""

from __future__ import annotations

from functools import lru_cache

import numpy as np

F32_PEAK_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12
SMS = 132
CLOCK_HZ = 1.98e9
ADDS_PER_SM_CLOCK = 128
COMPARES_PER_SM_CLOCK = 64


def bound_s(adds: int = 0, compares: int = 0, nbytes: int = 0) -> float:
    """The least time the card could take: the larger of the operations over
    their issue rate and the bytes over the HBM bandwidth."""
    return max(adds / (ADDS_PER_SM_CLOCK * SMS * CLOCK_HZ), compares / (COMPARES_PER_SM_CLOCK * SMS * CLOCK_HZ),
               nbytes / HBM_BYTES_PER_S)


def median_bytes(numel: int) -> int:
    """A float32 median filter over ``numel`` elements: each input read once, each output written once."""
    return 2 * 4 * numel


@lru_cache(maxsize=8)
def tempo_grid(min_bpm: float, max_bpm: float, fps: int) -> np.ndarray:
    """The DBN's beat intervals in frames, one a tempo (madmom's bar-pointer grid)."""
    min_int = int(np.floor(60.0 * fps / max_bpm))
    max_int = int(np.ceil(60.0 * fps / min_bpm))
    return np.arange(min_int, max_int + 1, dtype=np.int32)


def dbn_work(batch: int, frames: int, fps: int = 100, min_bpm: float = 55.0, max_bpm: float = 215.0) -> tuple[int, int, int]:
    """(adds, compares, bytes) of the DBN Viterbi over [batch, frames]: each
    frame after the first takes n x n tempo-transition candidates (an add and
    a compare each) and adds its observation to each valid (tempo, phase)
    state; the last frame's argmax compares each valid state. Bytes: the
    activations in, the phases and intervals out, the transition matrix."""
    grid = tempo_grid(min_bpm, max_bpm, fps)
    n, valid = len(grid), int(grid.sum())
    adds = batch * (frames - 1) * (n * n + valid)
    compares = batch * ((frames - 1) * n * n + valid)
    return adds, compares, batch * frames * 4 + 2 * batch * frames * 4 + n * n * 4
