"""Viterbi decoders (counterpart of audiotabs_tpu/decode/viterbi.py).

The lax.scans of the JAX package are plain loops over frames that stay on
the tensor's device. Parity trap: every argmax/argmin returns the FIRST
extremum, as jnp's do; torch's do so on the CPU and on CUDA.
"""

from __future__ import annotations

import math

import torch


def viterbi_constant_switch(emissions: torch.Tensor, switch_penalty: float):
    """Min-cost path through [S, T] emission probabilities → (path [T] int32, conf [T])."""
    S, T = emissions.shape
    logp = -torch.log(torch.clamp(emissions, 1e-9, 1.0))
    states = torch.arange(S, device=emissions.device)
    dp = logp[:, 0]
    bps = []
    for t in range(1, T):
        argm = torch.argmin(dp)
        switch_cost = dp.min() + switch_penalty
        # stay on s unless switching from the global argmin wins
        bps.append(torch.where(dp <= switch_cost, states, argm))
        dp = torch.minimum(dp, switch_cost) + logp[:, t]
    s = torch.argmin(dp).reshape(1)  # a 1-element index stays on the device
    path = [s]
    for bp in reversed(bps):
        s = bp[s]
        path.append(s)
    path = torch.cat(path[::-1])
    return path.to(torch.int32), emissions[path, torch.arange(T, device=emissions.device)]


def viterbi_log_dense(log_emissions: torch.Tensor, log_transition: torch.Tensor, log_initial: torch.Tensor | None = None):
    """Max-product Viterbi: [T, S] log-emissions, [S, S] log-transitions
    (transition[i, j] = log p(j at t+1 | i at t)) → (path [T] int32, final log-prob)."""
    T, S = log_emissions.shape
    if log_initial is None:
        log_initial = torch.full((S,), -math.log(S), device=log_emissions.device)
    score = log_initial + log_emissions[0]
    bps = []
    for t in range(1, T):
        cand = score[:, None] + log_transition  # [S_prev, S_next]
        bp = torch.argmax(cand, dim=0)
        score = cand.gather(0, bp[None])[0] + log_emissions[t]
        bps.append(bp)
    s = torch.argmax(score).reshape(1)  # a 1-element index stays on the device
    path = [s]
    for bp in reversed(bps):
        s = bp[s]
        path.append(s)
    return torch.cat(path[::-1]).to(torch.int32), score.max()
