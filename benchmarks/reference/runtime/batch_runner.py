"""The batch runner's decode and its chunk: many songs padded to one
common bucket multiple and stacked into a [B, T] batch (``_load_and_bucket``),
and one chunk [b, T] through htdemucs separation (``separate_program`` on
[b, L]) and ``fused_analysis_batch`` as one batched call (``_analyse_chunk``)."""

from __future__ import annotations

import logging
from pathlib import Path

import numpy as np
import torch

from ..config import Settings
from ..device import resolve_device
from .fused import fused_analysis_batch

_LOG = logging.getLogger(__name__)

ANALYSIS_SR = 22050


def _load_and_bucket(paths: list[Path], bucket_s: float) -> tuple[np.ndarray, list[int], int]:
    """Load all songs, resample to the analysis rate, pad to ONE common
    bucket multiple → ([B, T] batch, true lengths, sr).

    The JAX batch path's decode order: mono mean, peak-normalise at the
    native rate, then resample (the single-song path resamples first)."""
    from ..io.resample import resample_poly_host
    from ..io.wav import load_wav, peak_normalize

    signals = []
    for p in paths:
        y, sr = load_wav(p)
        y = peak_normalize(y)
        if sr != ANALYSIS_SR:
            y = resample_poly_host(y, sr, ANALYSIS_SR)
        signals.append(y)
    true_lens = [len(y) for y in signals]
    bucket = int(bucket_s * ANALYSIS_SR)
    T = ((max(true_lens) + bucket - 1) // bucket) * bucket
    batch = np.zeros((len(signals), T), dtype=np.float32)
    for i, y in enumerate(signals):
        batch[i, : len(y)] = y
        # wrap-pad the tail with the song itself
        rem = T - len(y)
        if rem > 0 and len(y) > 0:
            reps = int(np.ceil(rem / len(y)))
            batch[i, len(y) :] = np.tile(y, reps)[:rem]
    return batch, true_lens, ANALYSIS_SR


def _resolve_separation(s: Settings, sr: int, device: torch.device):
    """→ (sep_cfg, the htdemucs module on ``device``, chosen stem name), or
    (None, None, None) when separation is off or has no weights.

    ``sep_cfg`` = (seg, stride, shifts, n_sources, stem_idx, drums_idx), from
    ``htdemucs.program_config``, the single-song path's source of truth."""
    if not (s.ENABLE_DEMUCS and sr in (44100, 22050)):
        return None, None, None
    from ..models import htdemucs as hd

    params = hd.load_params()
    if params is None:
        return None, None, None
    cfg = hd.program_config(params, s.DEMUCS_MODEL, s.stem_priority())
    sep_cfg = (
        cfg["seg"], cfg["stride"], int(s.DEMUCS_SHIFTS),
        cfg["n_sources"], cfg["stem_idx"], cfg["drums_idx"],
    )
    return sep_cfg, hd.load_model(device), cfg["names"][cfg["stem_idx"]]


def _analyse_chunk(y: torch.Tensor, true_lens: np.ndarray, sr: int, s: Settings, sep_cfg, model) -> dict:
    """One chunk [b, T] on the device: separation (when configured) and the
    batched fused analysis. As in the JAX batch program, the net runs in
    float32 whatever ``DEMUCS_BF16`` says."""
    backend = s.CHORD_DETECTION_BACKEND
    kwargs = dict(
        switch_penalty=s.SWITCH_PENALTY,
        separate=s.ENABLE_DEMUCS,
        chord_backend=backend if backend in ("deep", "template") else "both",
        true_lens=true_lens,
    )
    if sep_cfg is None:
        return fused_analysis_batch(y, sr, **kwargs)
    from ..models.htdemucs import separate_program

    seg, stride, shifts, _n_sources, stem_idx, drums_idx = sep_cfg
    stems = separate_program(model, y, sr, seg, stride, shifts)  # [b, S, T]
    kwargs["separate"] = False
    return fused_analysis_batch(
        stems[:, stem_idx].contiguous(), sr, y_beat=stems[:, drums_idx].contiguous(), y_mix=y, **kwargs
    )
