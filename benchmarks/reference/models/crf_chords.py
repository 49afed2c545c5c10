"""CRF chord recognition (counterpart of audiotabs_tpu/models/crf_chords.py).

A linear-chain CRF over 25 states (N, 12 maj, 12 min): a linear emission
layer over [T, D] features, then the dense Viterbi of decode/viterbi.py;
``decode`` takes a batch of songs [B, T, D] too.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.nn.functional as F

from ..decode.viterbi import viterbi_log_dense
from ..theory.vocabulary import NOTE_NAMES_SHARP, NOTE_TO_PC, QUALITY_INTERVALS
from . import convert
from .params_io import load_pytree_npz, weights_path

LABELS = tuple(["N"] + [f"{n}:maj" for n in NOTE_NAMES_SHARP] + [f"{n}:min" for n in NOTE_NAMES_SHARP])
N_STATES = len(LABELS)  # 25

# frames whose harmonic RMS is below this fraction of the clip's peak get
# zeroed features (uniform emissions, decoded as N)
SILENCE_GATE_FRAC = 0.05


def init_params(generator: torch.Generator, feature_dim: int = 12) -> dict:
    """Random init (numpy), as the JAX ``init_params``: emissions N(0, 0.01),
    the self-transition-heavy prior, a uniform initial distribution."""
    trans = np.full((N_STATES, N_STATES), np.log(0.02 / (N_STATES - 1)), dtype=np.float32)
    np.fill_diagonal(trans, np.log(0.98))
    return {
        "emit_w": (torch.randn((feature_dim, N_STATES), generator=generator) * 0.1).numpy(),
        "emit_b": np.zeros((N_STATES,), np.float32),
        "transitions": trans,
        "initial": np.full((N_STATES,), -np.log(N_STATES), np.float32),
    }


def template_emission_params() -> dict:
    """Analytic emission weights from chord templates (numpy pytree)."""
    w = np.full((12, N_STATES), -0.35, dtype=np.float32)
    w[:, 0] = 0.0
    for s, label in enumerate(LABELS[1:], start=1):
        root, qual = label.split(":")
        for iv in QUALITY_INTERVALS[qual]:
            w[(NOTE_TO_PC[root] + iv) % 12, s] = 1.0
    w /= np.linalg.norm(w, axis=0, keepdims=True) + 1e-9
    trans = np.full((N_STATES, N_STATES), np.log(0.02 / (N_STATES - 1)), dtype=np.float32)
    np.fill_diagonal(trans, np.log(0.98))
    return {
        "emit_w": w * 8.0,  # temperature
        "emit_b": np.zeros((N_STATES,), np.float32),
        "transitions": trans,
        "initial": np.full((N_STATES,), -np.log(N_STATES), np.float32),
    }


def load_params(path: str | None = None) -> dict | None:
    path = weights_path("CRF_CHORDS_WEIGHTS", "crf_chords.npz") if path is None else path
    if not path or not os.path.exists(path):
        return None
    data = load_pytree_npz(path)
    needed = {"emit_w", "emit_b", "transitions", "initial"}
    if not needed.issubset(data):
        return None
    return {k: data[k] for k in needed}


def context_stack(feats: torch.Tensor, width: int) -> torch.Tensor:
    """[T, D] → [T, D*width]: the ±(width//2) neighbouring frames, zero-padded."""
    if width == 1:
        return feats
    half = width // 2
    padded = F.pad(feats, (0, 0, half, half))
    T = feats.shape[0]
    return torch.cat([padded[k : k + T] for k in range(width)], dim=-1)


def decode(params: dict, feats: torch.Tensor):
    """feats [T, D] or [B, T, D] → (state path [T] or [B, T] int32,
    confidence [T] or [B, T]).

    ``params`` is the numpy pytree of load_params/template_emission_params.
    Gated (all-zero) frames decode as N whatever the emission weights. The
    emission layer runs song by song, so a song's emissions, and its path,
    do not depend on the batch it comes in; the Viterbi decodes the whole
    batch in one call (one kernel launch on the card)."""
    if feats.ndim not in (2, 3):
        raise ValueError(f"decode takes [T, D] or [B, T, D] features, got shape {tuple(feats.shape)}")
    songs = feats if feats.ndim == 3 else feats[None]
    p = convert.crf_tensors(params, feats.device)
    d_in = p["emit_w"].shape[0]

    def log_emissions(f):
        if d_in != f.shape[-1] and d_in % f.shape[-1] == 0:
            f = context_stack(f, d_in // f.shape[-1])
        return torch.log_softmax(f @ p["emit_w"] + p["emit_b"], dim=-1)

    log_em = torch.stack([log_emissions(f) for f in songs])
    path, _score = viterbi_log_dense(log_em, p["transitions"], p["initial"])
    silent = songs.abs().max(dim=-1).values < 1e-8
    path = torch.where(silent, torch.zeros_like(path), path)
    conf = torch.exp(log_em.gather(-1, path.long()[..., None])[..., 0])
    return (path, conf) if feats.ndim == 3 else (path[0], conf[0])
