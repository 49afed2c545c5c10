"""Chord template library and emission model (counterpart of audiotabs_tpu/chords/templates.py)."""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from ..ops.spectral import as_device
from ..theory.vocabulary import NOTE_NAMES_SHARP, QUALITY_INTERVALS

NON_CHORD_TONE_PENALTY = 0.35
COMPLEXITY_PENALTY = 0.18
N_STATE_BIAS = 2.0
N_STATE_SLOPE = 6.0

_VOCAB_QUALITIES = {
    "majmin": ("maj", "min"),
    "majmin7": ("maj", "min", "7", "min7"),
    "majmin7plus": ("maj", "min", "7", "min7", "maj7"),
}
_SEVENTH_QUALITIES = {"7", "min7", "maj7"}


@lru_cache(maxsize=4)
def build_chord_library(vocab: str = "majmin7") -> tuple[tuple[str, ...], np.ndarray]:
    """→ (labels with labels[0]='N', templates [n_states, 12] L2-normalised)."""
    qualities = _VOCAB_QUALITIES.get(vocab, _VOCAB_QUALITIES["majmin7plus"])
    labels = ["N"]
    rows = [np.zeros(12, dtype=np.float32)]
    for root in range(12):
        for q in qualities:
            v = np.full(12, -NON_CHORD_TONE_PENALTY, dtype=np.float32)
            for iv in QUALITY_INTERVALS[q]:
                v[(root + iv) % 12] = 1.0
            rows.append(v)
            labels.append(f"{NOTE_NAMES_SHARP[root]}:{q}")
    T = np.stack(rows)
    T /= np.linalg.norm(T, axis=1, keepdims=True) + 1e-9
    return tuple(labels), T


def emission_probs(chroma: torch.Tensor, energy: torch.Tensor, labels: tuple[str, ...], templates: np.ndarray):
    """[12, T] L2-normalised chroma + [T] energy → [states, T] probabilities."""
    scores = as_device(templates, chroma) @ chroma  # [states, T]
    penalties = np.array(
        [COMPLEXITY_PENALTY if lbl.partition(":")[2] in _SEVENTH_QUALITIES else 0.0 for lbl in labels], dtype=np.float32
    )
    scores = scores - as_device(penalties, chroma)[:, None]
    energy = torch.clamp(energy, 0.0, 1.0)
    scores = torch.cat([(N_STATE_BIAS - N_STATE_SLOPE * energy)[None], scores[1:]], dim=0)
    ex = torch.exp(scores - scores.max(dim=0, keepdim=True).values)
    return ex / (ex.sum(dim=0, keepdim=True) + 1e-9)
