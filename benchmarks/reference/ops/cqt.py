"""Constant-Q transform as one GEMM against a numpy-built kernel bank.

Counterpart of audiotabs_tpu/ops/cqt.py, where XLA lowers the strided
convolution to a GEMM. Here the reflect-padded signal is unfolded into
hop-strided frames of the bank's length K and multiplied by the [K, 2B]
bank with torch.matmul (cuBLAS on the card), a plain large matrix product.
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch

from .spectral import as_device, frame


@lru_cache(maxsize=8)
def cqt_kernel_bank(
    sr: int,
    fmin: float = 32.70319566257483,  # C1
    n_bins: int = 84,
    bins_per_octave: int = 12,
    filter_scale: float = 1.0,
    max_kernel_len: int | None = None,
) -> tuple[np.ndarray, np.ndarray, int]:
    """Build the CQT kernel bank → (bank [K, 2*n_bins] f32 real|imag, freqs, K).

    Parity trap: kernels are built in f64/complex128 and cast to f32 once,
    as in the JAX package."""
    q = filter_scale / (2.0 ** (1.0 / bins_per_octave) - 1.0)
    freqs = fmin * 2.0 ** (np.arange(n_bins) / bins_per_octave)
    if freqs[-1] > sr / 2:
        raise ValueError(f"CQT top bin {freqs[-1]:.1f} Hz exceeds Nyquist {sr/2}")
    lengths = np.ceil(q * sr / freqs).astype(int)
    k_max = int(lengths.max())
    K = ((k_max + 127) // 128) * 128
    if max_kernel_len is not None:
        K = min(K, ((max_kernel_len + 127) // 128) * 128)

    bank = np.zeros((K, 2 * n_bins), dtype=np.float32)
    for b in range(n_bins):
        nk = min(int(lengths[b]), K)
        n = np.arange(nk) - nk / 2.0
        win = 0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(nk) / nk)
        kern = win * np.exp(2j * np.pi * freqs[b] * n / sr)
        kern /= win.sum()
        start = (K - nk) // 2
        bank[start : start + nk, b] = kern.real
        bank[start : start + nk, n_bins + b] = kern.imag
    return bank, freqs.astype(np.float32), K


def cqt(
    x: torch.Tensor,
    sr: int,
    hop: int = 512,
    fmin: float = 32.70319566257483,
    n_bins: int = 84,
    bins_per_octave: int = 12,
    filter_scale: float = 1.0,
    magnitude: bool = True,
    max_kernel_len: int | None = None,
):
    """CQT of x [..., T] → [..., n_bins, n_frames] (magnitude or complex)."""
    bank_np, _, K = cqt_kernel_bank(sr, fmin, n_bins, bins_per_octave, filter_scale, max_kernel_len)
    # K is even, so frames of length K at hop stride over the reflect-padded
    # signal are exactly the VALID strided convolution of the JAX package
    frames = frame(x, K, hop, center=True, pad_mode="reflect")  # [..., nf, K]
    proj = torch.matmul(frames, as_device(bank_np, x))  # [..., nf, 2B]
    re, im = proj[..., :n_bins], proj[..., n_bins:]
    out = torch.sqrt(re * re + im * im + 1e-20) if magnitude else torch.complex(re, im)
    return out.transpose(-1, -2)  # [..., n_bins, nf]


def hybrid_cqt(
    x: torch.Tensor,
    sr: int,
    hop: int = 512,
    fmin: float = 32.70319566257483,
    n_bins: int = 84,
    bins_per_octave: int = 12,
    harmonics: tuple[float, ...] = (0.5, 1, 2, 3, 4, 5, 6, 7),
    max_kernel_len: int = 16384,
):
    """Harmonically-stacked CQT [..., H, n_bins, n_frames] from ONE base CQT
    shifted by round(bpo·log2 h) bins per harmonic (out-of-range bins zero)."""
    shifts = [int(round(bins_per_octave * math.log2(h))) for h in harmonics]
    lo, hi = min(shifts), max(shifts)
    base_fmin = fmin * 2.0 ** (lo / bins_per_octave)
    nyq_bins = int(math.floor(bins_per_octave * math.log2((sr / 2.0) / base_fmin)))
    total_bins = min(n_bins + hi - lo, nyq_bins)
    base = cqt(x, sr, hop=hop, fmin=base_fmin, n_bins=total_bins, bins_per_octave=bins_per_octave, max_kernel_len=max_kernel_len)
    outs = []
    for s in shifts:
        start = s - lo
        avail = max(0, min(n_bins, total_bins - start))
        sl = base[..., start : start + avail, :]
        if avail < n_bins:
            sl = torch.nn.functional.pad(sl, (0, 0, 0, n_bins - avail))
        outs.append(sl)
    return torch.stack(outs, dim=-3)
