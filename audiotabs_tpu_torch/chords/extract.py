"""Chord chroma from AMT salience (counterpart of part of audiotabs_tpu/chords/extract.py)."""

from __future__ import annotations

import numpy as np
import torch

from ..ops.spectral import as_device

CHROMA_FPS = 10.0


def _pool_matrix(t_in: int, t_out: int) -> np.ndarray:
    """[t_out, t_in] mean-pooling matrix for frame-rate conversion."""
    m = np.zeros((t_out, t_in), dtype=np.float32)
    step = t_in / max(t_out, 1)
    for i in range(t_out):
        a, b = int(i * step), max(int((i + 1) * step), int(i * step) + 1)
        m[i, a:b] = 1.0 / (b - a)
    return m


def salience_chroma(frame_post: torch.Tensor, t_out: int) -> torch.Tensor:
    """AMT frame posteriors [T_amt, 88] → chord chroma [12, t_out] at 10 fps."""
    fold = np.zeros((88, 12), dtype=np.float32)
    for p in range(88):
        fold[p, (21 + p) % 12] = 1.0
    pcs = frame_post @ as_device(fold, frame_post)  # [T_amt, 12]
    return (as_device(_pool_matrix(int(frame_post.shape[0]), t_out), frame_post) @ pcs).T
