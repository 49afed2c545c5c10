"""Chord extraction (counterpart of audiotabs_tpu/chords/extract.py).

``salience_chroma`` folds the AMT salience into chord chroma on the device.
``extract_chords_deep`` turns the fused analysis' chroma and CRF path into
chord segments on the host (beat-synchronous majority vote, min-length
merging), arithmetic unchanged. Its branch that decodes audio itself, and
the template backend ``extract_chords``, are not ported (ROADMAP.md,
queue 1, item 14).
"""

from __future__ import annotations

import numpy as np
import torch

from ..models import crf_chords
from ..ops.spectral import as_device
from ..schemas import ChordSegment
from .segments import beat_sync_majority, frames_to_segments

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


def extract_chords_deep(
    y: np.ndarray,
    sr: int,
    *,
    min_segment_sec: float = 0.25,
    beat_times: np.ndarray | None = None,
    precomputed_chroma: np.ndarray | None = None,
    precomputed_path: tuple[np.ndarray, np.ndarray] | None = None,
) -> tuple[np.ndarray, np.ndarray, list[ChordSegment]]:
    """Deep backend, after the fused program: its chroma ``precomputed_chroma``
    [12, T] (DeepChroma when the weights exist, else salience chroma) and its
    CRF decode ``precomputed_path`` (path [T], conf [T]) → (chroma, frame
    times, chord segments), host post-processing only."""
    if precomputed_chroma is None or precomputed_path is None:
        raise NotImplementedError(
            "extract_chords_deep without the fused chroma and CRF path is not ported (ROADMAP.md, queue 1, item 14)"
        )
    chroma_np = np.asarray(precomputed_chroma)
    path_np = np.asarray(precomputed_path[0]).copy()
    conf_np = np.asarray(precomputed_path[1])

    # beat-sync smoothing reuses the same majority vote; the proxy carries
    # the frame confidence at EVERY state so frames relabeled by the vote
    # keep their confidence instead of reading 0
    emissions_proxy = np.broadcast_to(
        conf_np[None, :], (crf_chords.N_STATES, path_np.shape[0])
    ).copy()
    path_np, conf_np = beat_sync_majority(path_np, emissions_proxy, beat_times, CHROMA_FPS)

    times = np.arange(path_np.shape[0], dtype=np.float32) / CHROMA_FPS
    segments = frames_to_segments(
        path_np, conf_np, times, crf_chords.LABELS, min_len=min_segment_sec
    )
    return chroma_np, times, segments
