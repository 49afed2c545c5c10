"""Sliding-window median along one of the last two axes, for HPSS.

The CUDA kernel (``csrc/median_filter.cu``) replaces the TPU kernel
``audiotabs_tpu/ops/pallas_median.py::_median_kernel``: an exact,
edge-replicated, odd-window median of float32 data. It reads the window along
either axis of an [F, T] or [B, F, T] tensor through its strides, so the
frequency-direction median needs no transposed copy and a batch is a grid
index. What bounds it on the card, and what its design does about that, is
written at the top of the CUDA source.

For the windows in ``NET_OUTPUTS`` each CUDA thread runs a straight-line
min/max program that ``median_schedule`` builds here: ``k`` adjacent outputs
share the sort of what their windows have in common. ``schedule_header``
writes the same programs as the C++ header the kernel includes, and the CPU
tests interpret them with torch.minimum/torch.maximum, so the card runs the
network the tests checked.

``median_filter`` launches the kernel for a CUDA tensor and takes the plain
PyTorch version for a CPU tensor; there is no fallback from one to the other.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from .. import _build

# Windows with a selection network in the kernel, and the adjacent outputs each
# thread computes for them. More outputs share more of the sort but need more
# registers and round a short axis up further; these were the fastest on the
# main path's shapes (PERF.md). Other odd windows take the rank kernel.
NET_OUTPUTS = {5: 2, 17: 8, 31: 16}


@dataclass(frozen=True)
class Schedule:
    """A straight-line min/max program for ``k`` adjacent medians of window ``win``.

    Registers 0 .. win+k-2 start with the inputs x[p-h], ..., x[p+k-1+h] of the
    outputs p, ..., p+k-1 (h = win // 2). Each op ``(kind, dst, a, b)`` sets
    r[dst] = kind(r[a], r[b]) with kind "min" or "max"; output j ends in
    r[outputs[j]]. ``n_regs`` is the size of the register file."""

    win: int
    k: int
    n_regs: int
    ops: tuple[tuple[str, int, int, int], ...]
    outputs: tuple[int, ...]

    @property
    def ops_per_output(self) -> float:
        return len(self.ops) / self.k

    def run(self, inputs, lo=torch.minimum, hi=torch.maximum) -> list:
        """Interpret the program on ``win + k - 1`` inputs; ``lo``/``hi`` are min and max."""
        if len(inputs) != self.win + self.k - 1:
            raise ValueError(f"schedule takes {self.win + self.k - 1} inputs, got {len(inputs)}")
        r = list(inputs) + [None] * (self.n_regs - len(inputs))
        for kind, d, a, b in self.ops:
            r[d] = (lo if kind == "min" else hi)(r[a], r[b])
        return [r[o] for o in self.outputs]


class _Network:
    """Min/max gates in creation (topological) order, with common
    subexpressions merged. Values 0..n_inputs-1 are the inputs."""

    def __init__(self, n_inputs: int):
        self.n_inputs = n_inputs
        self.gates: list[tuple[str, int, int]] = []
        self._ids: dict[tuple[str, int, int], int] = {}

    def gate(self, kind: str, a: int, b: int) -> int:
        key = (kind, min(a, b), max(a, b))
        if key not in self._ids:
            self._ids[key] = self.n_inputs + len(self.gates)
            self.gates.append(key)
        return self._ids[key]

    def exchange(self, a: int, b: int) -> tuple[int, int]:
        return self.gate("min", a, b), self.gate("max", a, b)

    def merge(self, a: list[int], b: list[int]) -> list[int]:
        """Batcher's odd-even merge of two sorted lists of any lengths."""
        if not a or not b:
            return list(a or b)
        if len(a) == 1 and len(b) == 1:
            return list(self.exchange(a[0], b[0]))
        even, odd = self.merge(a[0::2], b[0::2]), self.merge(a[1::2], b[1::2])
        out = [v for pair in zip(even, odd) for v in pair] + even[len(odd):]
        for i in range(1, len(out) - 1, 2):
            out[i], out[i + 1] = self.exchange(out[i], out[i + 1])
        return out

    def sort(self, xs: list[int]) -> list[int]:
        if len(xs) <= 1:
            return list(xs)
        mid = len(xs) // 2
        return self.merge(self.sort(xs[:mid]), self.sort(xs[mid:]))


@functools.lru_cache(maxsize=None)
def median_schedule(win: int, k: int) -> Schedule:
    """The selection network for ``k`` adjacent outputs of an odd window ``win``.

    Windows lo..hi-1 of the inputs share the core [hi-1, lo+win-1]; with n of
    them, only the core's ranks h-n+1 .. h can still be a median (each window
    adds n-1 values), so those n candidates are all a node keeps. The root
    sorts the core of all k windows once. A node splits its windows in two
    halves; each half adds the values its windows share outside the parent's
    core (the left half [mid-1, hi-2], the right half [lo+win, mid+win-1]),
    merges their sort into the candidates and keeps the middle ranks. A single
    window's one candidate is its median. Gates no output needs are dropped."""
    h = win // 2
    if win % 2 != 1 or not 1 <= k <= h + 1:
        raise ValueError(f"median_schedule takes an odd window and 1 <= k <= win // 2 + 1, got {win}, {k}")
    net = _Network(win + k - 1)
    cand = net.sort(list(range(k - 1, win)))[h - k + 1 : h + 1]
    outputs: list[int] = []

    def split(cand: list[int], lo: int, hi: int) -> None:
        n = hi - lo
        if n == 1:
            outputs.append(cand[0])
            return
        mid = lo + n // 2
        for c_lo, c_hi, extra in ((lo, mid, range(mid - 1, hi - 1)), (mid, hi, range(lo + win, mid + win))):
            m = c_hi - c_lo
            split(net.merge(cand, net.sort(list(extra)))[n - m : n], c_lo, c_hi)

    split(cand, 0, k)
    return _allocate(net, win, k, outputs)


def _allocate(net: _Network, win: int, k: int, outputs: list[int]) -> Schedule:
    """Drop dead gates and give each live value a register, reusing freed ones."""
    n_in = net.n_inputs
    live = set(outputs)
    for i in range(len(net.gates) - 1, -1, -1):
        if n_in + i in live:
            live.update(net.gates[i][1:])
    order = [i for i in range(len(net.gates)) if n_in + i in live]
    last_use = {v: t for t, i in enumerate(order) for v in net.gates[i][1:]}
    last_use.update({v: len(order) for v in outputs})  # outputs stay to the end
    reg = {v: v for v in range(n_in)}
    free = sorted(v for v in range(n_in) if v not in last_use)
    n_regs = n_in
    ops = []
    for t, i in enumerate(order):
        kind, a, b = net.gates[i]
        for v in {a, b}:
            if last_use[v] == t:
                free.append(reg[v])
        free.sort()
        if free:
            dst = free.pop(0)
        else:
            dst, n_regs = n_regs, n_regs + 1
        reg[n_in + i] = dst
        ops.append((kind, dst, reg[a], reg[b]))
    return Schedule(win, k, n_regs, tuple(ops), tuple(reg[v] for v in outputs))


def schedule_header() -> str:
    """The C++ header of the networks in NET_OUTPUTS, included by csrc/median_filter.cu."""
    out = [
        "// Generated by audiotabs_tpu_torch/ops/median.py::schedule_header from",
        "// median_schedule(win, k); the CPU tests interpret the same operations.",
        "#pragma once",
        "",
        "template <int WIN>",
        "struct MedianNet;",
    ]
    for win, k in sorted(NET_OUTPUTS.items()):
        s = median_schedule(win, k)
        out += [
            "",
            f"// window {win}: {k} adjacent outputs from r[0..{win + k - 2}], {len(s.ops)} min/max",
            "template <>",
            f"struct MedianNet<{win}> {{",
            f"  static constexpr int kOutputs = {k};",
            f"  static constexpr int kRegs = {s.n_regs};",
            "  static __device__ __forceinline__ void run(float (&r)[kRegs], float (&m)[kOutputs]) {",
        ]
        out += [f"    r[{d}] = f{kind}f(r[{a}], r[{b}]);" for kind, d, a, b in s.ops]
        out += [f"    m[{j}] = r[{o}];" for j, o in enumerate(s.outputs)]
        out += ["  }", "};"]
    out += ["", "#define MEDIAN_NET_WINDOWS(X) " + " ".join(f"X({w})" for w in sorted(NET_OUTPUTS)), ""]
    return "\n".join(out)


def _headers() -> dict[str, str]:
    return {"median_schedule.h": schedule_header()}


_ARGTYPES = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 5 + [ctypes.c_void_p]


def ptxas_usage() -> dict[str, dict[str, int]]:
    """Registers and spill bytes of each kernel instantiation, from the build's ``-Xptxas -v``."""
    return _build.ptxas_usage("median_filter", _headers())


def _check(x: torch.Tensor, win: int, axis: int) -> int:
    if x.dtype != torch.float32:
        raise TypeError(f"median_filter takes float32, got {x.dtype}")
    if x.ndim not in (2, 3):
        raise ValueError(f"median_filter takes [F, T] or [B, F, T], got shape {tuple(x.shape)}")
    if not (isinstance(win, int) and win % 2 == 1 and 1 <= win < 128):
        raise ValueError(f"window must be an odd int below 128, got {win!r}")
    if axis not in (-1, -2, x.ndim - 1, x.ndim - 2):
        raise ValueError(f"axis must be one of the last two, got {axis}")
    return axis % x.ndim


def median_filter_plain(x: torch.Tensor, win: int, axis: int = -1) -> torch.Tensor:
    """The plain version: replicate-pad, unfold the window, take its median.

    For an odd window torch.median returns the exact middle element, as
    jnp.median does (audiotabs_tpu/ops/hpss.py:_median_filter_lastaxis)."""
    axis = _check(x, win, axis)
    xt = x if axis == x.ndim - 1 else x.transpose(-1, -2)
    lead = xt.shape[:-1]
    half = win // 2
    xp = F.pad(xt.reshape(1, -1, xt.shape[-1]), (half, half), mode="replicate")
    med = xp.unfold(-1, win, 1).median(dim=-1).values.reshape(*lead, xt.shape[-1])
    return med if axis == x.ndim - 1 else med.transpose(-1, -2).contiguous()


def median_filter(x: torch.Tensor, win: int, axis: int = -1) -> torch.Tensor:
    """Median over a window of ``win`` along ``axis`` (-1 or -2), edges replicated.

    CUDA tensors (contiguous float32) launch the kernel; CPU tensors take
    median_filter_plain. Any other device raises, and so does a device
    tensor that requires grad: the kernel has no backward (the JAX Pallas
    kernel has no VJP either, and no trainer differentiates through HPSS)."""
    axis = _check(x, win, axis)
    if x.device.type != "cpu" and x.requires_grad and torch.is_grad_enabled():
        raise RuntimeError("median_filter has no backward: detach the input or run under torch.no_grad()")
    return _build.plain_or_kernel("median_filter", median_filter_plain, _median_filter_cuda, x, win, axis)


def _median_filter_cuda(x: torch.Tensor, win: int, axis: int) -> torch.Tensor:
    """The median on the card: one launch."""
    if not x.is_contiguous():
        raise ValueError("median_filter needs a contiguous tensor")
    y = torch.empty_like(x)
    _build.launch("median_filter", "median_filter_f32", _ARGTYPES, x.device, x, y, x.shape[0] if x.ndim == 3 else 1,
                  x.shape[-2], x.shape[-1], win, int(axis == x.ndim - 1), headers=_headers)
    return y
