"""Chord extraction: chroma features → emissions → Viterbi → segments.

Counterpart of audiotabs_tpu/chords/extract.py. ``salience_chroma`` folds
the AMT salience into chord chroma on the device. ``extract_chords_deep``
turns the fused analysis' chroma and CRF path into chord segments on the
host (beat-synchronous majority vote, min-length merging); without them it
computes its chroma (DeepChroma, or the salience chroma of
``chroma_features``) and the CRF decode on the device first.
``extract_chords`` is the template backend: chroma, template emissions and
the constant-switch Viterbi on the device, then the same host
post-processing. The device stages run on the input tensor's device, or on
``device`` for a host array (the card unless the caller names the CPU).
"""

from __future__ import annotations

import numpy as np
import torch

from ..decode.viterbi import viterbi_constant_switch
from ..device import on_device
from ..models import crf_chords
from ..ops.features import rms
from ..ops.spectral import as_device
from ..schemas import ChordSegment
from .segments import beat_sync_majority, frames_to_segments
from .templates import build_chord_library, emission_probs

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


def chroma_features(y, sr: int, fps: float = CHROMA_FPS, *, device=None) -> tuple[torch.Tensor, torch.Tensor]:
    """→ ([12, T] L2-normalised chroma, [T] energy) at ``fps`` frames/s, on
    the device: the pitch-class folding of the fundamental-gated AMT salience
    of ``y`` (already the harmonic component in the pipeline)."""
    from ..models.basicpitch import salience_posteriors

    hop = int(round(sr / fps))
    yd = on_device(y, device)
    t_out = yd.shape[-1] // hop + 1
    _onset, frame_post = salience_posteriors(yd, sr)
    chroma = salience_chroma(frame_post, t_out)  # [12, T]
    chroma_norm = chroma / (torch.linalg.vector_norm(chroma, dim=0, keepdim=True) + 1e-9)
    energy = rms(yd, frame_length=2048, hop=hop)
    n = min(chroma_norm.shape[-1], energy.shape[-1])
    energy = energy[:n]
    energy = energy / (energy.max() + 1e-9)
    return chroma_norm[:, :n], energy


def _post(path_np, emissions_np, beat_times, labels, min_segment_sec):
    """Beat-synchronous majority vote, then min-length segments (host numpy)."""
    path_np, conf_np = beat_sync_majority(path_np, emissions_np, beat_times, CHROMA_FPS)
    times = np.arange(path_np.shape[0], dtype=np.float32) / CHROMA_FPS
    return times, frames_to_segments(path_np, conf_np, times, labels, min_len=min_segment_sec)


@torch.inference_mode()
def extract_chords_deep(
    y,
    sr: int,
    *,
    min_segment_sec: float = 0.25,
    beat_times: np.ndarray | None = None,
    precomputed_chroma: np.ndarray | None = None,
    precomputed_path: tuple[np.ndarray, np.ndarray] | None = None,
    device=None,
) -> tuple[np.ndarray, np.ndarray, list[ChordSegment]]:
    """Deep backend → (chroma [12, T], frame times, chord segments).

    With the fused program's chroma ``precomputed_chroma`` [12, T] and CRF
    decode ``precomputed_path`` (path [T], conf [T]) this is host
    post-processing only. Otherwise the chroma (the DeepChroma DNN when its
    weights load, else ``precomputed_chroma``, else the salience chroma) is
    silence-gated and decoded by the CRF on the device."""
    if precomputed_chroma is not None and precomputed_path is not None:
        chroma_np = np.asarray(precomputed_chroma)
        path_np = np.asarray(precomputed_path[0]).copy()
        conf_np = np.asarray(precomputed_path[1])
    else:
        from ..models.deepchroma import deep_chroma_apply
        from ..models.deepchroma import load_params as load_dc

        yd = on_device(y, device)
        dc_params = load_dc()
        if dc_params is not None:
            chroma_np = deep_chroma_apply(dc_params, yd, sr)  # [12, T]
            chroma = as_device(chroma_np, yd)
        elif precomputed_chroma is not None:
            chroma_np = np.asarray(precomputed_chroma)
            chroma = as_device(chroma_np.astype(np.float32), yd)
        else:
            chroma, _energy = chroma_features(yd, sr)
            chroma_np = chroma.cpu().numpy()

        crf_params = crf_chords.load_params() or crf_chords.template_emission_params()
        feats = chroma.T  # [T, 12]
        feats = feats / torch.clamp(torch.linalg.vector_norm(feats, dim=1, keepdim=True), min=1e-9)
        # silence gate (as in runtime/fused.py): near-silent frames get zeroed
        # features, so the CRF extends a neighbour instead of decoding noise
        hop = int(round(sr / CHROMA_FPS))
        energy = rms(yd, frame_length=2048, hop=hop).cpu().numpy()
        energy = energy / (energy.max() + 1e-9)
        if energy.shape[0] < feats.shape[0]:
            energy = np.pad(energy, (0, feats.shape[0] - energy.shape[0]), constant_values=1.0)
        gate = (energy[: feats.shape[0]] > crf_chords.SILENCE_GATE_FRAC).astype(np.float32)
        path, conf = crf_chords.decode(crf_params, feats * as_device(gate, yd)[:, None])
        path_np, conf_np = path.cpu().numpy().copy(), conf.cpu().numpy()

    # beat-sync smoothing reuses the same majority vote; the proxy carries
    # the frame confidence at EVERY state so frames relabeled by the vote
    # keep their confidence instead of reading 0
    emissions_proxy = np.broadcast_to(conf_np[None, :], (crf_chords.N_STATES, path_np.shape[0])).copy()
    times, segments = _post(path_np, emissions_proxy, beat_times, crf_chords.LABELS, min_segment_sec)
    return chroma_np, times, segments


@torch.inference_mode()
def extract_chords(
    y,
    sr: int,
    *,
    vocab: str = "majmin7",
    switch_penalty: float = 2.5,
    min_segment_sec: float = 0.25,
    beat_times: np.ndarray | None = None,
    deep_params=None,
    backend: str | None = None,
    device=None,
) -> tuple[np.ndarray, np.ndarray, list[ChordSegment]]:
    """→ (chroma [12, T], times [T] s, chord segments).

    "deep" = ``extract_chords_deep``; "template" = chroma (the DeepChroma
    DNN of ``deep_params``, else the salience chroma), template emissions of
    ``vocab`` and the constant-switch Viterbi. ``backend`` None reads
    ``CHORD_DETECTION_BACKEND`` from the environment's ``Settings``."""
    if backend is None:
        from ..config import Settings

        backend = Settings.from_env().CHORD_DETECTION_BACKEND
    if backend == "deep":
        return extract_chords_deep(y, sr, min_segment_sec=min_segment_sec, beat_times=beat_times, device=device)
    yd = on_device(y, device)
    if deep_params is not None:
        from ..models.deepchroma import deep_chroma_apply

        chroma_np = deep_chroma_apply(deep_params, yd, sr)  # [12, T] at 10 fps
        energy = as_device(np.clip(chroma_np.mean(axis=0), 0.0, 1.0), yd)
        chroma = as_device(chroma_np / (np.linalg.norm(chroma_np, axis=0, keepdims=True) + 1e-9), yd)
    else:
        chroma, energy = chroma_features(yd, sr)

    labels, templates = build_chord_library(vocab)
    emissions = emission_probs(chroma, energy, labels, templates)
    path, _conf = viterbi_constant_switch(emissions, switch_penalty)
    emissions_np = emissions.cpu().numpy()
    times, segments = _post(path.cpu().numpy(), emissions_np, beat_times, labels, min_segment_sec)
    return chroma.cpu().numpy(), times, segments
