"""pYIN probabilistic pitch tracking over a batch of signals.

Counterpart of audiotabs_tpu/ops/pyin.py (Mauch & Dixon 2014): YIN CMNDF by
FFT cross-correlation, Beta(2, 18) threshold prior, trough probabilities to
pitch-bin observations, and a banded Viterbi over [voiced | unvoiced] bins.
The Viterbi's lax.scans (forward and backtrack) are one launch of the CUDA
kernel csrc/banded_viterbi.cu for every row of a batch on the card, and a
plain loop over frames on the CPU (``_banded_viterbi_plain``). The
content-window metrics call it on a batch of windows (the JAX package vmaps
it). torch computes every logarithm the kernel takes (``_transition``), so
the kernel and the loop agree bit for bit.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache
from math import comb

import numpy as np
import torch
import torch.nn.functional as F

from .. import _build
from .spectral import as_device, frame


@lru_cache(maxsize=4)
def _beta_pmf(n_thresholds: int = 100, a: int = 2, b: int = 18) -> np.ndarray:
    """Discretised Beta(a, b) prior over YIN thresholds in (0, 1].

    For integer a and b the Beta CDF is the binomial tail
    I_x(a, b) = Σ_{j=a}^{a+b-1} C(a+b-1, j) x^j (1-x)^(a+b-1-j)
    (the JAX package evaluates the same CDF with scipy)."""
    x = np.linspace(0, 1, n_thresholds + 1)
    n = a + b - 1
    cdf = sum(comb(n, j) * x**j * (1.0 - x) ** (n - j) for j in range(a, n + 1))
    return np.diff(cdf).astype(np.float32)


def _yin_frames(y: torch.Tensor, frame_length: int, hop: int):
    """CMNDF [..., n_frames, max_lag + 1] with max_lag = frame_length // 2."""
    fr = frame(y, frame_length, hop, center=True)  # [..., T, L]
    L = frame_length
    W = L // 2
    n_fft = 2 * L
    spec_full = torch.fft.rfft(fr, n=n_fft, dim=-1)
    spec_head = torch.fft.rfft(fr[..., :W], n=n_fft, dim=-1)
    # cross(tau) = sum_{j<W} x[j] x[j+tau]
    cross = torch.fft.irfft(spec_full * torch.conj(spec_head), n=n_fft, dim=-1)[..., : W + 1]
    sq = fr * fr
    csum = torch.cat([torch.zeros_like(sq[..., :1]), torch.cumsum(sq, dim=-1)], dim=-1)
    e0 = csum[..., W] - csum[..., 0]
    taus = torch.arange(W + 1, device=y.device)
    e_tau = csum[..., taus + W] - csum[..., taus]
    d = torch.clamp(e0[..., None] + e_tau - 2.0 * cross, min=0.0)
    cum = torch.cumsum(d[..., 1:], dim=-1)
    tau_range = torch.arange(1, W + 1, dtype=d.dtype, device=y.device)
    cmndf = d[..., 1:] * tau_range / torch.clamp(cum, min=1e-12)
    return torch.cat([torch.ones_like(d[..., :1]), cmndf], dim=-1)


def _parabolic_shift(d: torch.Tensor):
    """Sub-sample trough refinement: shift in [-0.5, 0.5] per lag."""
    prev = torch.roll(d, 1, dims=-1)
    nxt = torch.roll(d, -1, dims=-1)
    denom = 2.0 * (prev + nxt - 2.0 * d)
    shift = torch.where(
        denom.abs() > 1e-9, (prev - nxt) / torch.clamp(denom.abs(), min=1e-9) * torch.sign(denom), torch.zeros_like(d)
    )
    return torch.clamp(shift, -0.5, 0.5)


def _pyin_observations(
    y: torch.Tensor,
    sr: int,
    fmin: float,
    fmax: float,
    frame_length: int,
    hop: int,
    n_thresholds: int = 100,
    bins_per_semitone: int = 5,
):
    cmndf = _yin_frames(y, frame_length, hop)  # [..., T, W+1]
    W = cmndf.shape[-1] - 1
    dev = y.device
    taus = torch.arange(W + 1, dtype=torch.float32, device=dev)
    tau_min = int(np.floor(np.float32(sr / fmax)))
    tau_max = min(int(np.ceil(np.float32(sr / fmin))), W)
    in_range = (taus >= tau_min) & (taus <= tau_max)
    prev = torch.roll(cmndf, 1, dims=-1)
    nxt = torch.roll(cmndf, -1, dims=-1)
    is_trough = (cmndf <= prev) & (cmndf <= nxt) & in_range
    trough_val = torch.where(is_trough, cmndf, torch.full_like(cmndf, float("inf")))

    # Beta-prior thresholding: each threshold sends its mass to the FIRST
    # (smallest-lag) trough whose CMNDF is below it
    thresholds = (torch.arange(n_thresholds, dtype=torch.float32, device=dev) + 1.0) / n_thresholds
    pmf = as_device(_beta_pmf(n_thresholds), y)
    below = trough_val[..., None, :] < thresholds[:, None]  # [..., T, S, W+1]
    any_below = below.any(dim=-1)
    # argmax returns the first maximum, as jnp.argmax does
    first_idx = torch.argmax(below.to(torch.uint8), dim=-1)  # [..., T, S]
    global_min = torch.argmin(trough_val, dim=-1)  # [..., T]
    chosen = torch.where(any_below, first_idx, global_min[..., None])
    weight = torch.where(any_below, pmf, pmf * 0.01)
    lag_probs = torch.zeros_like(cmndf).scatter_add_(-1, chosen, weight)

    # refine lags and convert to pitch bins
    refined = taus + _parabolic_shift(cmndf)
    f0 = sr / torch.clamp(refined, min=1e-6)
    n_bins = int(round(12 * bins_per_semitone * np.log2(fmax / fmin))) + 1
    bin_idx = torch.round(12.0 * bins_per_semitone * torch.log2(torch.clamp(f0, min=1e-6) / fmin)).to(torch.int64)
    valid = (bin_idx >= 0) & (bin_idx < n_bins) & (lag_probs > 0)
    bin_idx = torch.clamp(bin_idx, 0, n_bins - 1)
    obs = cmndf.new_zeros(*cmndf.shape[:-1], n_bins)
    obs.scatter_add_(-1, bin_idx, torch.where(valid, lag_probs, torch.zeros_like(lag_probs)))
    voiced_prob = torch.clamp(obs.sum(-1), 0.0, 1.0)
    return obs, voiced_prob


def _transition(band: int, switch_prob: float, n_bins: int, device: torch.device):
    """(log_tri [2·band + 1] float32 on ``device``, log_stay, log_switch, the
    initial log score): the float32 values both versions of the Viterbi add."""
    offsets = torch.arange(-band, band + 1, device=device)
    tri = (band + 1.0 - offsets.abs()).to(torch.float32)
    log_tri = torch.log(tri / tri.sum())
    log_stay = np.log1p(np.float32(-switch_prob))
    log_switch = np.log(np.float32(switch_prob))
    init = np.log(np.float32(0.5 / n_bins))
    return log_tri, float(log_stay), float(log_switch), float(init)


def _banded_viterbi_plain(log_obs_v: torch.Tensor, log_obs_u: torch.Tensor, band: int, switch_prob: float):
    """The plain version: a loop over frames, then over them backwards."""
    T, B = log_obs_v.shape[-2:]
    lead = log_obs_v.shape[:-2]
    log_tri, log_stay, log_switch, init = _transition(band, switch_prob, B, log_obs_v.device)

    def shift_scores(s):
        """max-plus banded propagation: out[b] = max_d s[b+d] + log_tri[d]."""
        cand = F.pad(s, (band, band), value=float("-inf")).unfold(-1, 2 * band + 1, 1) + log_tri
        return cand.max(dim=-1).values, torch.argmax(cand, dim=-1) - band

    sv = torch.full((*lead, B), init, device=log_obs_v.device)
    su = sv.clone()
    bps = []
    for t in range(T):
        pv, av = shift_scores(sv)
        pu, au = shift_scores(su)
        nv_stay, nv_sw = pv + log_stay, pu + log_switch
        nu_stay, nu_sw = pu + log_stay, pv + log_switch
        sv = torch.maximum(nv_stay, nv_sw) + log_obs_v[..., t, :]
        su = torch.maximum(nu_stay, nu_sw) + log_obs_u[..., t, :]
        bps.append((av, au, nv_sw > nv_stay, nu_sw > nu_stay))

    is_v = sv.max(dim=-1).values >= su.max(dim=-1).values
    b = torch.where(is_v, torch.argmax(sv, dim=-1), torch.argmax(su, dim=-1))
    bins, voiced = [], []
    for av, au, nv_from_u, nu_from_v in reversed(bps):
        bins.append(b)
        voiced.append(is_v)
        at = b[..., None]
        prev_is_v = torch.where(is_v, ~nv_from_u.gather(-1, at)[..., 0], nu_from_v.gather(-1, at)[..., 0])
        delta = torch.where(prev_is_v, av.gather(-1, at)[..., 0], au.gather(-1, at)[..., 0])
        b = torch.clamp(b + delta, 0, B - 1)
        is_v = prev_is_v
    return torch.stack(bins[::-1], dim=-1), torch.stack(voiced[::-1], dim=-1)


_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_float] * 3 + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p]


def _launch_args(log_obs_v: torch.Tensor, log_obs_u: torch.Tensor, band: int, switch_prob: float) -> tuple:
    """The kernel's arguments for [..., T, B] on the card: the [rows, T, B]
    float32 observations, the transition values torch computes, the scratch
    of the kernel's frame records ([rows, T, B, 4] float32: both propagated
    maxima and both previous scores), the outputs (bins, voiced [rows, T])
    and the band."""
    T, B = log_obs_v.shape[-2:]
    dev = log_obs_v.device
    log_tri, log_stay, log_switch, init = _transition(band, switch_prob, B, dev)
    ov = log_obs_v.to(torch.float32).reshape(-1, T, B).contiguous()
    ou = log_obs_u.to(torch.float32).expand_as(log_obs_v).reshape(-1, T, B).contiguous()
    rows = ov.shape[0]
    records = torch.empty((rows, T, B, 4), dtype=torch.float32, device=dev)
    bins = torch.empty((rows, T), dtype=torch.int64, device=dev)
    voiced = torch.empty((rows, T), dtype=torch.bool, device=dev)
    return ov, ou, log_tri, log_stay, log_switch, init, records, bins, voiced, band


def _banded_viterbi_cuda(log_obs_v: torch.Tensor, log_obs_u: torch.Tensor, band: int, switch_prob: float):
    """The Viterbi on the card: one launch, one block per row, a group of 4 lanes per 4 bins."""
    T, B = log_obs_v.shape[-2:]
    if B > 1024 or not 1 <= band <= 127:
        raise ValueError(f"the banded Viterbi kernel takes at most 1024 bins and a band of 1 to 127, got {B} and {band}")
    *args, band = _launch_args(log_obs_v, log_obs_u, band, switch_prob)
    bins, voiced = args[-2], args[-1]
    _build.launch("banded_viterbi", "banded_viterbi_f32", _ARGTYPES, bins.device, *args, bins.shape[0], T, B, band)
    lead = log_obs_v.shape[:-2]
    return bins.reshape(*lead, T), voiced.reshape(*lead, T)


def _banded_viterbi(log_obs_v: torch.Tensor, log_obs_u: torch.Tensor, band: int, switch_prob: float):
    """Viterbi over [voiced bins | unvoiced bins] [..., T, B] with banded pitch moves.

    Returns (bin path [..., T] int64, voiced path [..., T] bool). A CUDA
    tensor launches csrc/banded_viterbi.cu, a CPU tensor takes the plain
    loop; any other device raises."""
    return _build.plain_or_kernel("_banded_viterbi", _banded_viterbi_plain, _banded_viterbi_cuda, log_obs_v, log_obs_u, band,
                                  switch_prob)


def pyin(
    y: torch.Tensor,
    sr: int,
    fmin: float = 65.40639132514966,  # C2
    fmax: float = 2093.004522404789,  # C7
    frame_length: int = 2048,
    hop: int = 512,
    bins_per_semitone: int = 5,
    switch_prob: float = 0.01,
    max_semitones_per_frame: float = 5.0,
):
    """Pitch-track y [..., N] → (f0 [..., T] Hz, voiced_flag [..., T], voiced_prob [..., T])."""
    obs, voiced_prob = _pyin_observations(y, sr, fmin, fmax, frame_length, hop, bins_per_semitone=bins_per_semitone)
    n_bins = int(round(12 * bins_per_semitone * np.log2(fmax / fmin))) + 1
    eps = 1e-10
    log_obs_v = torch.log(obs + eps)
    # unvoiced evidence is spread uniformly
    log_obs_u = (torch.log(torch.clamp(1.0 - voiced_prob, min=eps) / n_bins)[..., None]).expand_as(obs)
    band = max(1, min(int(round(max_semitones_per_frame * bins_per_semitone)), n_bins - 1))
    bins, voiced = _banded_viterbi(log_obs_v, log_obs_u, band, switch_prob)
    f0 = fmin * 2.0 ** (bins.to(torch.float32) / (12.0 * bins_per_semitone))
    return f0, voiced, voiced_prob
