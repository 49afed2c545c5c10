"""Viterbi decoders (counterpart of audiotabs_tpu/decode/viterbi.py).

``viterbi_log_dense`` (the CRF chord decode) and ``viterbi_constant_switch``
(the template chord backend) are each one launch of a CUDA kernel for a
batch of sequences on the card (csrc/dense_viterbi.cu,
csrc/constant_switch_viterbi.cu), and a plain loop over frames on the CPU
(``viterbi_log_dense_plain``, ``viterbi_constant_switch_plain``). Parity
trap: every argmax/argmin returns the FIRST extremum, as jnp's do; torch's
do so on the CPU and on CUDA, and the kernels keep the lowest state on a
tie. The constant-switch decode stays on ``s`` when ``dp[s] <= min +
penalty``: a tie stays, whatever state holds the minimum.
"""

from __future__ import annotations

import ctypes
import math

import torch

from .. import _build


def viterbi_constant_switch_plain(emissions: torch.Tensor, switch_penalty: float):
    """The plain version on [B, S, T]: a loop over frames, then over them backwards."""
    B, S, T = emissions.shape
    logp = -torch.log(torch.clamp(emissions, 1e-9, 1.0))
    states = torch.arange(S, device=emissions.device)
    dp = logp[:, :, 0]
    bps = []
    for t in range(1, T):
        argm = torch.argmin(dp, dim=1, keepdim=True)
        switch_cost = dp.min(dim=1, keepdim=True).values + switch_penalty
        # stay on s unless switching from the global argmin wins
        bps.append(torch.where(dp <= switch_cost, states, argm))
        dp = torch.minimum(dp, switch_cost) + logp[:, :, t]
    s = torch.argmin(dp, dim=1)
    path = [s]
    for bp in reversed(bps):
        s = bp.gather(1, s[:, None])[:, 0]
        path.append(s)
    path = torch.stack(path[::-1], dim=1)
    return path.to(torch.int32), emissions.gather(1, path[:, None, :])[:, 0]


_SWITCH_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_float, ctypes.c_void_p]


def _switch_launch_args(emissions: torch.Tensor, switch_penalty: float) -> tuple:
    """The kernel's arguments for [B, S, T] float32 emissions on the card:
    the costs -log(clamp(emissions, 1e-9, 1)) from torch, the emissions (the
    kernel gathers the confidences), the scratch of the backtrack (each
    frame's scores [B, T, 32 K], K = ceil(S / 32), then its minimum [B, T]),
    the path [B, T], the confidences [B, T] and the penalty."""
    if emissions.dtype != torch.float32:
        raise TypeError(f"the constant-switch Viterbi kernel takes float32 emissions, got {emissions.dtype}")
    B, S, T = emissions.shape
    dev = emissions.device
    return (
        (-torch.log(torch.clamp(emissions, 1e-9, 1.0))).contiguous(),
        emissions.contiguous(),
        torch.empty(B * T * (32 * -(-S // 32) + 1), dtype=torch.float32, device=dev),
        torch.empty((B, T), dtype=torch.int32, device=dev),
        torch.empty((B, T), dtype=torch.float32, device=dev),
        float(switch_penalty),
    )


def _viterbi_constant_switch_cuda(emissions: torch.Tensor, switch_penalty: float):
    """[B, S, T] on the card: one launch, one warp per sequence, which gathers the confidences too."""
    *args, penalty = _switch_launch_args(emissions, switch_penalty)
    B, S, T = emissions.shape
    _build.launch("constant_switch_viterbi", "constant_switch_viterbi_f32", _SWITCH_ARGTYPES, emissions.device, *args, B, T, S,
                  penalty, refused={-1: f"{B} sequences of {T} frames and {S} states (at most 64)"})
    return args[3], args[4]


def viterbi_constant_switch(emissions: torch.Tensor, switch_penalty: float):
    """Min-cost path through [S, T] or [B, S, T] emission probabilities →
    (path [T] or [B, T] int32, conf [T] or [B, T]: the emission of the chosen state).

    A CUDA tensor launches csrc/constant_switch_viterbi.cu, a CPU tensor takes
    the plain loop; any other device raises."""
    if emissions.ndim not in (2, 3):
        raise ValueError(f"viterbi_constant_switch takes [S, T] or [B, S, T], got shape {tuple(emissions.shape)}")
    em = emissions[None] if emissions.ndim == 2 else emissions
    path, conf = _build.plain_or_kernel("viterbi_constant_switch", viterbi_constant_switch_plain, _viterbi_constant_switch_cuda,
                                        em, switch_penalty)
    return (path, conf) if emissions.ndim == 3 else (path[0], conf[0])


def viterbi_log_dense_plain(log_emissions: torch.Tensor, log_transition: torch.Tensor, log_initial: torch.Tensor):
    """The plain version on [B, T, S]: a loop over frames, then over them
    backwards. A NaN sum is the maximum, as jnp's: torch.argmax takes the
    first NaN and the gathered score is that NaN."""
    T = log_emissions.shape[1]
    score = log_initial + log_emissions[:, 0]
    bps = []
    for t in range(1, T):
        cand = score[:, :, None] + log_transition  # [B, S_prev, S_next]
        bp = torch.argmax(cand, dim=1)
        score = cand.gather(1, bp[:, None])[:, 0] + log_emissions[:, t]
        bps.append(bp)
    s = torch.argmax(score, dim=-1)
    path = [s]
    for bp in reversed(bps):
        s = bp.gather(1, s[:, None])[:, 0]
        path.append(s)
    return torch.stack(path[::-1], dim=1).to(torch.int32), score.max(dim=-1).values


_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [ctypes.c_void_p]


# the most states the kernel takes; up to 32 run in its warp layout (one warp per sequence)
MAX_STATES = 1024
WARP_STATES = 32
INT32_MAX = 2**31 - 1


def _launch_args(log_emissions: torch.Tensor, log_transition: torch.Tensor, log_initial: torch.Tensor) -> tuple:
    """The kernel's arguments for [B, T, S] on the card: the float32 inputs,
    the scratch of its frame records ([B, T - 1, 2, max(S, 32)] float32:
    each frame's score and the maximum entering the next frame) and the
    outputs (path [B, T], best [B]). Raises ValueError, before anything is
    allocated, for a shape the kernel does not take."""
    B, T, S = log_emissions.shape
    if S > MAX_STATES:
        raise ValueError(f"the dense Viterbi kernel takes at most {MAX_STATES} states, got {S}")
    if B > INT32_MAX or T * S > INT32_MAX:
        raise ValueError(f"the dense Viterbi kernel takes fewer than 2**31 sequences and emissions per sequence, got [{B}, {T}, {S}]")
    dev = log_emissions.device
    return (
        log_emissions.to(torch.float32).contiguous(),
        log_transition.to(device=dev, dtype=torch.float32).contiguous(),
        log_initial.to(device=dev, dtype=torch.float32).contiguous(),
        torch.empty((B, max(T - 1, 1), 2, max(S, WARP_STATES)), dtype=torch.float32, device=dev),
        torch.empty((B, T), dtype=torch.int32, device=dev),
        torch.empty((B,), dtype=torch.float32, device=dev),
    )


def _viterbi_log_dense_cuda(log_emissions: torch.Tensor, log_transition: torch.Tensor, log_initial: torch.Tensor):
    """[B, T, S] on the card: one launch, a warp per sequence up to 32 states, else a block per sequence."""
    args = _launch_args(log_emissions, log_transition, log_initial)
    _build.launch("dense_viterbi", "dense_viterbi_f32", _ARGTYPES, log_emissions.device, *args, *log_emissions.shape)
    return args[-2], args[-1]


def viterbi_log_dense(log_emissions: torch.Tensor, log_transition: torch.Tensor, log_initial: torch.Tensor | None = None):
    """Max-product Viterbi: [T, S] or [B, T, S] log-emissions, [S, S]
    log-transitions (transition[i, j] = log p(j at t+1 | i at t)) → (path
    [T] or [B, T] int32, final log-prob: a scalar or [B]).

    A CUDA tensor launches csrc/dense_viterbi.cu, a CPU tensor takes the
    plain loop; any other device raises."""
    if log_emissions.ndim not in (2, 3):
        raise ValueError(f"viterbi_log_dense takes [T, S] or [B, T, S], got shape {tuple(log_emissions.shape)}")
    em = log_emissions[None] if log_emissions.ndim == 2 else log_emissions
    if log_initial is None:
        log_initial = torch.full((em.shape[-1],), -math.log(em.shape[-1]), device=em.device)
    path, best = _build.plain_or_kernel("viterbi_log_dense", viterbi_log_dense_plain, _viterbi_log_dense_cuda, em, log_transition,
                                        log_initial)
    return (path, best) if log_emissions.ndim == 3 else (path[0], best[0])
