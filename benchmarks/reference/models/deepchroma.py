"""Deep chroma DNN (counterpart of audiotabs_tpu/models/deepchroma.py).

Context-stacked log-filtered spectrogram frames at 10 fps → 3 ReLU layers
of 512 → 12 sigmoid chroma units, as an nn.Module; ``deep_chroma_apply`` is
the whole path from audio.
"""

from __future__ import annotations

import os
from functools import lru_cache

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..device import on_device
from ..ops.spectral import as_device, hann_window
from ..ops.spectral import frame as frame_signal
from . import convert
from .params_io import load_pytree_npz, weights_path

FPS = 10
CONTEXT = 7  # frames each side
FMIN, FMAX = 65.0, 2100.0
BINS_PER_OCTAVE = 24
N_BANDS = 120


@lru_cache(maxsize=4)
def _filterbank(sr: int, n_fft: int) -> np.ndarray:
    """Quarter-tone triangular filterbank [n_bands, n_fft//2+1] (f64 edges, f32 bank)."""
    n_oct = np.log2(FMAX / FMIN)
    n_bands = int(np.floor(n_oct * BINS_PER_OCTAVE))
    centers = FMIN * 2.0 ** (np.arange(n_bands + 2) / BINS_PER_OCTAVE)
    freqs = np.linspace(0, sr / 2.0, n_fft // 2 + 1)
    fb = np.zeros((n_bands, len(freqs)), dtype=np.float32)
    for i in range(n_bands):
        lo, ctr, hi = centers[i], centers[i + 1], centers[i + 2]
        fb[i] = np.maximum(0, np.minimum((freqs - lo) / max(ctr - lo, 1e-9), (hi - freqs) / max(hi - ctr, 1e-9)))
        ssum = fb[i].sum()
        if ssum > 0:
            fb[i] /= ssum
    return fb


def log_filtered(y: torch.Tensor, sr: int, fps: int) -> torch.Tensor:
    """log1p of the filterbank-banded magnitude spectrogram → [T, n_bands]."""
    n_fft = 8192 if sr > 30000 else 4096
    frames = frame_signal(y, n_fft, sr // fps, center=True)
    mag = torch.abs(torch.fft.rfft(frames * as_device(hann_window(n_fft), y), dim=-1))
    return torch.log1p(mag @ as_device(_filterbank(sr, n_fft), y).T)


def features(y: torch.Tensor, sr: int) -> torch.Tensor:
    """Context-stacked log-filtered spectrogram [T, (2*CONTEXT+1)*n_bands] at 10 fps."""
    banded = log_filtered(y, sr, FPS)  # [T, B]
    T = banded.shape[0]
    padded = F.pad(banded, (0, 0, CONTEXT, CONTEXT))
    return padded.unfold(0, 2 * CONTEXT + 1, 1).transpose(1, 2).reshape(T, -1)


class DeepChromaDNN(nn.Module):
    """[T, D] features → [T, 12] sigmoid chroma."""

    def __init__(self, input_dim: int, hidden: int = 512, n_layers: int = 3, normalize: bool = False):
        super().__init__()
        dims = [input_dim] + [hidden] * n_layers
        self.layers = nn.ModuleList(nn.Linear(a, b) for a, b in zip(dims[:-1], dims[1:]))
        self.out = nn.Linear(hidden, 12)
        if normalize:
            self.register_buffer("feat_mean", torch.zeros(input_dim))
            self.register_buffer("feat_std", torch.ones(input_dim))
        else:
            self.feat_mean = self.feat_std = None

    @classmethod
    def from_params(cls, params: dict) -> "DeepChromaDNN":
        w0 = np.asarray(params["layers"][0]["w"])
        net = cls(w0.shape[0], w0.shape[1], len(params["layers"]), "feat_mean" in params)
        net.load_state_dict(convert.deepchroma_state(params))
        return net

    def forward(self, feats: torch.Tensor) -> torch.Tensor:
        x = feats
        if self.feat_mean is not None:
            x = (x - self.feat_mean) / self.feat_std
        for layer in self.layers:
            x = F.relu(layer(x))
        return torch.sigmoid(self.out(x))


def apply(net: DeepChromaDNN, feats: torch.Tensor) -> torch.Tensor:
    return net(feats)


@torch.inference_mode()
def deep_chroma_apply(params: dict, y, sr: int, *, device=None) -> np.ndarray:
    """Full path on the device: audio → [12, T] chroma at 10 fps (host numpy).
    ``y`` is a tensor (its device is used) or a host array (uploaded to
    ``device``, the card unless the caller names the CPU)."""
    yd = on_device(y, device)
    net = DeepChromaDNN.from_params(params).to(yd.device).eval()
    return net(features(yd, sr)).T.cpu().numpy()


def init_params(generator: torch.Generator, input_dim: int, hidden: int = 512, n_layers: int = 3) -> dict:
    """Random init of the JAX pytree (numpy), as the JAX ``init_params``: ReLU
    layers N(0, 2/fan_in), the output layer N(0, 1/fan_in), zero biases."""
    params: dict = {"layers": []}
    d = input_dim
    for _ in range(n_layers):
        params["layers"].append({"w": (torch.randn((d, hidden), generator=generator) * np.sqrt(2.0 / d)).numpy(),
                                 "b": np.zeros((hidden,), np.float32)})
        d = hidden
    params["out_w"] = (torch.randn((d, 12), generator=generator) * np.sqrt(1.0 / d)).numpy()
    params["out_b"] = np.zeros((12,), np.float32)
    return params


def params_of(net: DeepChromaDNN, template: dict) -> dict:
    return convert.to_pytree(convert.deepchroma_state, template, net.state_dict())


def save_params(path: str, params: dict) -> None:
    """The JAX trainer's flat layout (l<i>_w, l<i>_b, out_*, feat_*), which load_params reads."""
    flat = {}
    for i, layer in enumerate(params["layers"]):
        flat[f"l{i}_w"], flat[f"l{i}_b"] = np.asarray(layer["w"]), np.asarray(layer["b"])
    for k in ("out_w", "out_b", "feat_mean", "feat_std"):
        if k in params:
            flat[k] = np.asarray(params[k])
    np.savez(path, **flat)


def load_params(path: str | None = None) -> dict | None:
    path = weights_path("DEEPCHROMA_WEIGHTS", "deepchroma.npz") if path is None else path
    if not path or not os.path.exists(path):
        return None
    data = load_pytree_npz(path)
    layers = []
    while f"l{len(layers)}_w" in data:
        i = len(layers)
        layers.append({"w": data[f"l{i}_w"], "b": data[f"l{i}_b"]})
    if not layers:
        return None
    out = {"layers": layers, "out_w": data["out_w"], "out_b": data["out_b"]}
    for k in ("feat_mean", "feat_std"):
        if k in data:
            out[k] = data[k]
    return out
