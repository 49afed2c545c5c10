"""Chroma features (12 pitch classes) from the CQT.

Counterpart of audiotabs_tpu/ops/chroma.py (replaces librosa.feature.chroma_cqt,
reference: backend/app/services/chords/template.py:88-101). fmin is C1
throughout, so CQT bin b has pitch class b % 12 with C == 0.
"""

from __future__ import annotations

import torch

from .cqt import cqt


def chroma_from_cqt(C: torch.Tensor, bins_per_octave: int = 12, norm: bool = True) -> torch.Tensor:
    """Fold CQT magnitude [..., n_bins, T] to chroma [..., 12, T]."""
    n_bins = C.shape[-2]
    bins_per_pc = bins_per_octave // 12
    if bins_per_pc > 1:
        # collapse sub-semitone bins first
        usable = (n_bins // bins_per_pc) * bins_per_pc
        C = C[..., :usable, :]
        C = C.reshape(C.shape[:-2] + (usable // bins_per_pc, bins_per_pc, C.shape[-1])).sum(-2)
        n_bins = usable // bins_per_pc
    usable = (n_bins // 12) * 12
    folded = C[..., :usable, :].reshape(C.shape[:-2] + (usable // 12, 12, C.shape[-1])).sum(-3)
    rem = n_bins - usable
    if rem:
        folded = torch.cat([folded[..., :rem, :] + C[..., usable:, :], folded[..., rem:, :]], dim=-2)
    if norm:
        folded = folded / torch.clamp(folded.amax(dim=-2, keepdim=True), min=1e-8)
    return folded


def chroma_cqt(x: torch.Tensor, sr: int, hop: int = 512, n_octaves: int = 6, bins_per_octave: int = 36) -> torch.Tensor:
    """Signal [..., T] on its device → normalised chroma [..., 12, n_frames]."""
    C = cqt(x, sr, hop=hop, n_bins=n_octaves * bins_per_octave, bins_per_octave=bins_per_octave)
    return chroma_from_cqt(C, bins_per_octave=bins_per_octave)
