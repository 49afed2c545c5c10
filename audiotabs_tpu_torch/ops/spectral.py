"""STFT/ISTFT and framing, written out with torch.fft.

Counterpart of audiotabs_tpu/ops/spectral.py. Framing pads the centre
explicitly (``pad_mode`` "reflect" or "constant") and unfolds hop-strided
frames; the inverse is a windowed overlap-add normalised by the summed
squared window, as in the JAX package. torch.stft is not used: its centre
and normalisation conventions differ.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F

from ..tracing import uploaded


@lru_cache(maxsize=32)
def hann_window(n: int, periodic: bool = True) -> np.ndarray:
    """Hann window (periodic matches librosa/scipy sym=False)."""
    m = n if periodic else n - 1
    w = 0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(n) / max(m, 1))
    return w.astype(np.float32)


def num_frames(n_samples: int, frame_length: int, hop: int, center: bool = True) -> int:
    if center:
        return n_samples // hop + 1
    return max(0, 1 + (n_samples - frame_length) // hop)


def as_device(a: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    """A numpy constant (window, filterbank, bank) as a tensor on like's
    device. Always a copy: on the CPU a ``from_numpy`` view would share its
    memory with the ``lru_cache``d constant, and an in-place op on it would
    change the constant for every later caller in the process."""
    return uploaded(torch.from_numpy(np.ascontiguousarray(a)).to(like.device, copy=True))


@lru_cache(maxsize=32)
def device_hann(n: int, device: torch.device) -> torch.Tensor:
    """The periodic Hann window, uploaded once per device (not per call);
    a copy, never a view of ``hann_window``'s cached array."""
    with torch.inference_mode(False):  # a normal tensor, usable in and out of inference mode
        return uploaded(torch.from_numpy(hann_window(n)).to(device, copy=True))


def _pad_last(x: torch.Tensor, left: int, right: int, mode: str) -> torch.Tensor:
    """Pad the last axis of [..., T] (F.pad's reflect needs a [N, C, T] view)."""
    lead = x.shape[:-1]
    if mode == "constant":
        return F.pad(x, (left, right))
    xp = F.pad(x.reshape(1, -1, x.shape[-1]), (left, right), mode=mode)
    return xp.reshape(*lead, xp.shape[-1])


def frame(x: torch.Tensor, frame_length: int, hop: int, center: bool = True, pad_mode: str = "reflect"):
    """Slice a signal [..., T] into frames [..., n_frames, frame_length]."""
    if center:
        x = _pad_last(x, frame_length // 2, frame_length // 2, pad_mode)
    return x.unfold(-1, frame_length, hop)


def stft(
    x: torch.Tensor,
    n_fft: int = 2048,
    hop: int = 512,
    win_length: int | None = None,
    center: bool = True,
    window: np.ndarray | None = None,
    pad_mode: str = "reflect",
) -> torch.Tensor:
    """STFT → complex [..., n_fft//2+1, n_frames] (librosa axis order)."""
    win_length = win_length or n_fft
    if window is None and win_length == n_fft:
        w = device_hann(n_fft, x.device)
    else:
        w = window if window is not None else hann_window(win_length)
        if win_length < n_fft:
            lpad = (n_fft - win_length) // 2
            w = np.pad(np.asarray(w), (lpad, n_fft - win_length - lpad))
        w = as_device(np.asarray(w, dtype=np.float32), x)
    frames = frame(x, n_fft, hop, center=center, pad_mode=pad_mode)  # [..., nf, n_fft]
    spec = torch.fft.rfft(frames * w, dim=-1)
    return spec.transpose(-1, -2)  # [..., freq, time]


def istft(
    spec: torch.Tensor,
    hop: int = 512,
    win_length: int | None = None,
    center: bool = True,
    length: int | None = None,
) -> torch.Tensor:
    """Inverse STFT with Hann overlap-add and window-square normalisation."""
    spec = spec.transpose(-1, -2)  # [..., time, freq]
    n_fft = 2 * (spec.shape[-1] - 1)
    win_length = win_length or n_fft
    w = device_hann(win_length, spec.device)
    if win_length < n_fft:
        lpad = (n_fft - win_length) // 2
        w = F.pad(w, (lpad, n_fft - win_length - lpad))
    frames = torch.fft.irfft(spec, n=n_fft, dim=-1) * w  # [..., nf, n_fft]
    nf = frames.shape[-2]
    lead = frames.shape[:-2]
    out_len = n_fft + hop * (nf - 1)

    if n_fft % hop == 0:
        # overlap-add as R = n_fft/hop slice-adds: chunk c of frame f lands
        # on hop block f+c (the same summation order as the JAX package)
        R = n_fft // hop
        chunks = frames.reshape(*lead, nf, R, hop)
        sig2 = frames.new_zeros(*lead, nf + R - 1, hop)
        wc = (w * w).reshape(R, hop)
        ws2 = w.new_zeros(nf + R - 1, hop)
        for c in range(R):
            sig2[..., c : c + nf, :] += chunks[..., :, c, :]
            ws2[c : c + nf, :] += wc[c]
        sig = sig2.reshape(*lead, out_len)
        wsum = ws2.reshape(-1)
    else:
        idx = (torch.arange(nf, device=w.device)[:, None] * hop + torch.arange(n_fft, device=w.device)[None, :]).reshape(-1)
        sig = frames.new_zeros(*lead, out_len).index_add_(-1, idx, frames.reshape(*lead, -1))
        wsum = w.new_zeros(out_len).index_add_(0, idx, (w * w).repeat(nf))
    sig = sig / torch.clamp(wsum, min=1e-8)

    if center:
        sig = sig[..., n_fft // 2 :]
        sig = sig[..., :length] if length is not None else sig[..., : out_len - n_fft]
    elif length is not None:
        sig = sig[..., :length]
    return sig


def power_to_db(S: torch.Tensor, ref: float = 1.0, amin: float = 1e-10, top_db: float | None = 80.0):
    log_spec = 10.0 * torch.log10(torch.clamp(S, min=amin)) - 10.0 * float(np.log10(max(amin, ref)))
    if top_db is not None:
        log_spec = torch.maximum(log_spec, log_spec.max() - top_db)
    return log_spec


def magnitude_db(spec: torch.Tensor, top_db: float | None = 80.0):
    return power_to_db(torch.abs(spec) ** 2, top_db=top_db)
