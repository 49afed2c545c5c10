"""Viterbi decoders (counterpart of audiotabs_tpu/decode/viterbi.py).

``viterbi_log_dense`` (the CRF chord decode) and ``viterbi_constant_switch``
(the template chord backend) are plain loops over frames on every device
(``viterbi_log_dense_plain``, ``viterbi_constant_switch_plain``). Parity
trap: every argmax/argmin returns the FIRST extremum, as jnp's do; torch's
do so on the CPU and on CUDA. The constant-switch decode stays on ``s`` when ``dp[s] <= min +
penalty``: a tie stays, whatever state holds the minimum.
"""

from __future__ import annotations

import math

import torch

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


def viterbi_constant_switch(emissions: torch.Tensor, switch_penalty: float):
    """Min-cost path through [S, T] or [B, S, T] emission probabilities →
    (path [T] or [B, T] int32, conf [T] or [B, T]: the emission of the chosen state).

    The plain loop on every device."""
    if emissions.ndim not in (2, 3):
        raise ValueError(f"viterbi_constant_switch takes [S, T] or [B, S, T], got shape {tuple(emissions.shape)}")
    em = emissions[None] if emissions.ndim == 2 else emissions
    path, conf = viterbi_constant_switch_plain(em, switch_penalty)
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


def viterbi_log_dense(log_emissions: torch.Tensor, log_transition: torch.Tensor, log_initial: torch.Tensor | None = None):
    """Max-product Viterbi: [T, S] or [B, T, S] log-emissions, [S, S]
    log-transitions (transition[i, j] = log p(j at t+1 | i at t)) → (path
    [T] or [B, T] int32, final log-prob: a scalar or [B]).

    The plain loop on every device, on float32 inputs as the kernel takes them."""
    if log_emissions.ndim not in (2, 3):
        raise ValueError(f"viterbi_log_dense takes [T, S] or [B, T, S], got shape {tuple(log_emissions.shape)}")
    em = log_emissions[None] if log_emissions.ndim == 2 else log_emissions
    if log_initial is None:
        log_initial = torch.full((em.shape[-1],), -math.log(em.shape[-1]), device=em.device)
    dev = em.device
    path, best = viterbi_log_dense_plain(
        em.to(torch.float32), log_transition.to(device=dev, dtype=torch.float32), log_initial.to(device=dev, dtype=torch.float32)
    )
    return (path, best) if log_emissions.ndim == 3 else (path[0], best[0])
