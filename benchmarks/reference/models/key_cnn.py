"""Global key classification CNN (counterpart of audiotabs_tpu/models/key_cnn.py).

Log-filtered spectrogram at 5 fps → three ELU convolutions with band-axis
max pooling → time average (optionally masked) → dense softmax over 24 keys;
``key_prediction_to_label`` (host numpy) names the argmax, and
``estimate_key_cnn`` runs the whole path from audio.
"""

from __future__ import annotations

import logging
import os

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..device import on_device
from ..theory.vocabulary import NOTE_NAMES_SHARP
from . import convert
from .basicpitch import SameConv2d
from .deepchroma import N_BANDS, log_filtered
from .params_io import load_pytree_npz, weights_path

N_CLASSES = 24  # 12 major then 12 minor


def key_prediction_to_label(probs: np.ndarray) -> str:
    """argmax over 24 classes → 'C major' style label (madmom ordering)."""
    probs = np.asarray(probs).reshape(-1)
    idx = int(np.argmax(probs))
    tonic = NOTE_NAMES_SHARP[idx % 12]
    mode = "major" if idx < 12 else "minor"
    return f"{tonic} {mode}"


def features(y: torch.Tensor, sr: int) -> torch.Tensor:
    """Log-filtered spectrogram [T, B, 1] at ~5 fps."""
    return log_filtered(y, sr, 5)[..., None]


class KeyCNN(nn.Module):
    def __init__(self, n_bands: int = N_BANDS):
        super().__init__()
        self.c1 = SameConv2d(1, 8, (5, 5))
        self.c2 = SameConv2d(8, 16, (3, 3))
        self.c3 = SameConv2d(16, 32, (3, 3))
        self.out = nn.Linear((n_bands // 4) * 32, N_CLASSES)

    @classmethod
    def from_params(cls, params: dict) -> "KeyCNN":
        net = cls(np.asarray(params["out_w"]).shape[0] // 32 * 4)
        net.load_state_dict(convert.key_cnn_state(params))
        return net

    def forward(self, feats: torch.Tensor, frame_mask: torch.Tensor | None = None) -> torch.Tensor:
        """[T, B, 1] → [24] probabilities, or a batch [N, T, B, 1] → [N, 24];
        ``frame_mask`` [T] limits the time average."""
        single = feats.dim() == 3
        x = (feats[None] if single else feats).permute(0, 3, 1, 2)  # [N, 1, T, B]
        x = F.max_pool2d(F.elu(self.c1(x)), (1, 2))  # pool the band axis only
        x = F.max_pool2d(F.elu(self.c2(x)), (1, 2))
        x = F.elu(self.c3(x))  # [N, 32, T, B//4]
        if frame_mask is None:
            pooled = x.mean(dim=2)
        else:
            m = frame_mask.to(x.dtype)[None, None, :, None]
            pooled = (x * m).sum(dim=2) / torch.clamp(m.sum(), min=1.0)
        # the dense head reads the (band, channel) map flattened band-major
        probs = torch.softmax(self.out(pooled.transpose(1, 2).reshape(x.shape[0], -1)), dim=-1)
        return probs[0] if single else probs


def apply(net: KeyCNN, feats: torch.Tensor, frame_mask: torch.Tensor | None = None) -> torch.Tensor:
    return net(feats, frame_mask)


def init_params(generator: torch.Generator, n_bands: int = N_BANDS) -> dict:
    """Random init of the JAX pytree (numpy, HWIO convs), as the JAX
    ``init_params``: N(0, 2/fan_in) with fan-in all but the last dimension."""

    def he(shape):
        return (torch.randn(shape, generator=generator) * np.sqrt(2.0 / np.prod(shape[:-1]))).numpy()

    return {
        "c1_w": he((5, 5, 1, 8)), "c1_b": np.zeros((8,), np.float32),
        "c2_w": he((3, 3, 8, 16)), "c2_b": np.zeros((16,), np.float32),
        "c3_w": he((3, 3, 16, 32)), "c3_b": np.zeros((32,), np.float32),
        "out_w": he(((n_bands // 4) * 32, N_CLASSES)), "out_b": np.zeros((N_CLASSES,), np.float32),
    }


def params_of(net: KeyCNN, template: dict) -> dict:
    return convert.to_pytree(convert.key_cnn_state, template, net.state_dict())


def load_params(path: str | None = None) -> dict | None:
    path = weights_path("KEY_CNN_WEIGHTS", "key_cnn.npz") if path is None else path
    if not path or not os.path.exists(path):
        return None
    params = load_pytree_npz(path)
    ow = params.get("out_w")
    want = ((N_BANDS // 4) * 32, N_CLASSES)
    if ow is None or ow.shape != want:
        logging.getLogger(__name__).warning("key_cnn checkpoint %s rejected: out_w shape %s != %s", path, None if ow is None else ow.shape, want)
        return None
    return params


@torch.inference_mode()
def estimate_key_cnn(y, sr: int, params: dict | None = None, *, device=None):
    """Audio → KeyEstimate via the CNN on the device, None when no weights are loaded."""
    p = params or load_params()
    if p is None:
        return None
    yd = on_device(y, device)
    net = KeyCNN.from_params(p).to(yd.device).eval()
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        probs = net(features(yd, sr)).cpu().numpy()
    tonic, mode = key_prediction_to_label(probs).split()
    from ..theory.key import _make_estimate
    from ..theory.vocabulary import NOTE_TO_PC

    return _make_estimate(NOTE_TO_PC[tonic], mode, float(probs.max()))
