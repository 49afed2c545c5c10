"""Strum onset envelope (counterpart of audiotabs_tpu/accompaniment/strum.py::_onset_strength_median).

The host peak picking and quantisation wait for the next slice.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..ops.features import mel_filterbank
from ..ops.spectral import as_device, stft


def _onset_strength_median(y: torch.Tensor, sr: int, hop: int = 512, n_fft: int = 2048) -> torch.Tensor:
    """librosa-faithful onset strength, median-aggregated over mel bands:
    Slaney mel power → dB floored at max−80 → positive first difference →
    median over bands → shifted by 1 + n_fft//(2·hop) frames. Centre padding
    is "constant", librosa 0.10's melspectrogram default."""
    S = torch.abs(stft(y, n_fft=n_fft, hop=hop, pad_mode="constant")) ** 2
    M = as_device(mel_filterbank(sr, n_fft, 128, scale="slaney"), y) @ S
    db = 10.0 * torch.log10(torch.clamp(M, min=1e-10))
    db = torch.maximum(db, db.amax(dim=(-2, -1), keepdim=True) - 80.0)
    diff = torch.clamp(db[..., :, 1:] - db[..., :, :-1], min=0.0)
    # parity trap: 128 bands is an even count; jnp.median averages the two
    # middle values there, torch.median would return the lower one
    flux = torch.quantile(diff, 0.5, dim=-2)
    shift = 1 + n_fft // (2 * hop)  # +1 for the diff, + the window-centre lag
    return F.pad(flux, (shift, 0))[..., : S.shape[-1]]
