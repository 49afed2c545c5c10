"""Beat activation: the madmom-style BLSTM ensemble on nn.LSTM, and the
weight-free spectral-flux activation.

Counterpart of audiotabs_tpu/models/beat_rnn.py (spectral_features, the
BLSTM, blstm_apply, blstm_apply_chunked, the ensemble average of
beat_activation, onset_activation, init_params, load_params, save_params).
The JAX lax.scan recurrence becomes ``nn.LSTM(bidirectional=True)`` (cuDNN
on the card); the overlapped windows of the chunked form become the LSTM's
batch dimension. The JAX BLSTM has one gate bias per direction: it is
``bias_ih`` here and ``bias_hh`` stays zero (a trainer freezes it).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.cqt import cqt
from ..ops.spectral import as_device, hann_window
from ..ops.spectral import frame as frame_signal
from ..tracing import uploaded
from . import convert
from .params_io import load_pytree_npz, weights_path

FPS_DEFAULT = 100
_FRAME_SIZES = (1024, 2048, 4096)
_BANDS_PER_OCTAVE = 6
_FMIN, _FMAX = 30.0, 10000.0


@lru_cache(maxsize=16)
def _log_filterbank(sr: int, n_fft: int) -> np.ndarray:
    """Triangular filters on a log-frequency grid → [n_bands, n_fft//2+1] (f64 edges, f32 bank)."""
    n_oct = np.log2(_FMAX / _FMIN)
    n_bands = int(np.floor(n_oct * _BANDS_PER_OCTAVE))
    centers = _FMIN * 2.0 ** (np.arange(n_bands + 2) / _BANDS_PER_OCTAVE)
    freqs = np.linspace(0, sr / 2.0, n_fft // 2 + 1)
    fb = np.zeros((n_bands, len(freqs)), dtype=np.float32)
    for i in range(n_bands):
        lo, ctr, hi = centers[i], centers[i + 1], centers[i + 2]
        up = (freqs - lo) / max(ctr - lo, 1e-9)
        dn = (hi - freqs) / max(hi - ctr, 1e-9)
        fb[i] = np.maximum(0, np.minimum(up, dn))
        s = fb[i].sum()
        if s > 0:
            fb[i] /= s
    return fb


def spectral_features(y: torch.Tensor, sr: int, fps: int = FPS_DEFAULT) -> torch.Tensor:
    """Multi-resolution log-filtered magnitudes + positive first differences → [T, D]."""
    hop = sr // fps
    feats = []
    for n_fft in _FRAME_SIZES:
        frames = frame_signal(y, n_fft, hop, center=True)
        mag = torch.abs(torch.fft.rfft(frames * as_device(hann_window(n_fft), y), dim=-1))  # [T, F]
        logb = torch.log10(1.0 + 5.0 * (mag @ as_device(_log_filterbank(sr, n_fft), y).T))
        diff = torch.clamp(logb[1:] - logb[:-1], min=0.0)
        feats.append(logb)
        feats.append(torch.cat([torch.zeros_like(diff[:1]), diff], dim=0))
    n = min(f.shape[0] for f in feats)
    return torch.cat([f[:n] for f in feats], dim=-1)


class BeatBLSTM(nn.Module):
    """Stacked bidirectional LSTM + sigmoid head: [N, T, D] features → [N, T] activation."""

    def __init__(self, input_dim: int, hidden: int = 25, layers: int = 3, normalize: bool = False, full_context: bool = False):
        super().__init__()
        self.lstm = nn.LSTM(input_dim, hidden, layers, batch_first=True, bidirectional=True)
        self.out = nn.Linear(2 * hidden, 1)
        self.full_context = full_context
        if normalize:
            self.register_buffer("feat_mean", torch.zeros(input_dim))
            self.register_buffer("feat_std", torch.ones(input_dim))
        else:
            self.feat_mean = self.feat_std = None

    @classmethod
    def from_params(cls, params: dict) -> "BeatBLSTM":
        """One member's JAX pytree → module (weights through models/convert.py)."""
        layers = params["layers"]
        W = np.asarray(layers[0]["fwd"]["W"])
        net = cls(W.shape[0], np.asarray(layers[0]["fwd"]["U"]).shape[0], len(layers), "feat_mean" in params, "full_context" in params)
        net.load_state_dict(convert.beat_blstm_state(params))
        return net

    def forward(self, feats: torch.Tensor) -> torch.Tensor:
        x = feats
        if self.feat_mean is not None:
            x = (x - self.feat_mean) / self.feat_std
        h, _ = self.lstm(x)
        return torch.sigmoid(self.out(h)[..., 0])


def blstm_apply(net: BeatBLSTM, feats: torch.Tensor) -> torch.Tensor:
    """[T, D] features → [T] beat activation in (0, 1), one pass over the whole sequence."""
    return net(feats[None])[0]


def blstm_apply_chunked(net: BeatBLSTM, feats: torch.Tensor, window: int = 256, margin: int = 32) -> torch.Tensor:
    """[T, D] → [T] activation via overlapped windows run as one LSTM batch.

    The ``margin`` frames at each window edge are recomputed by the
    neighbouring window and discarded, as in the JAX package."""
    T, D = feats.shape
    if T <= window:
        return blstm_apply(net, feats)
    hop = window - 2 * margin
    nwin = -(-(T - 2 * margin) // hop)
    padT = nwin * hop + 2 * margin
    f = torch.cat([feats, feats[-1:].expand(padT - T, D)], dim=0)  # edge padding
    wins = f.unfold(0, window, hop).transpose(1, 2)  # [nwin, window, D]
    acts = net(wins.contiguous())  # [nwin, window]
    out = torch.cat([acts[0, :margin], acts[:, margin : window - margin].reshape(-1), acts[-1, window - margin :]])
    return out[:T]


def load_params(path: str | None = None) -> dict | None:
    """Trained BLSTM pytree (numpy) from the flat npz, None if absent. Extra
    ensemble members (m1_/m2_/… prefixes) load into an "ensemble" list."""
    import os

    path = weights_path("BEAT_RNN_WEIGHTS", "beat_rnn.npz") if path is None else path
    if not path or not os.path.exists(path):
        return None
    data = load_pytree_npz(path)

    def member(prefix: str) -> dict | None:
        layers = []
        while f"{prefix}l{len(layers)}_fwd_W" in data:
            i = len(layers)
            layers.append({d: {k: data[f"{prefix}l{i}_{d}_{k}"] for k in ("W", "U", "b")} for d in ("fwd", "bwd")})
        if not layers:
            return None
        out = {"layers": layers, "out_w": data[f"{prefix}out_w"], "out_b": data[f"{prefix}out_b"]}
        for k in ("feat_mean", "feat_std", "full_context"):
            if f"{prefix}{k}" in data:
                out[k] = data[f"{prefix}{k}"]
        return out

    out = member("")
    if out is None:
        return None
    members = []
    while f"m{len(members) + 1}_l0_fwd_W" in data:
        members.append(member(f"m{len(members) + 1}_"))
    if members:
        out["ensemble"] = members
    return out


def init_params(generator: torch.Generator, input_dim: int, hidden: int = 25, layers: int = 3) -> dict:
    """Random init of the JAX pytree (numpy): every weight N(0, 1/fan_in) with
    fan-in its first dimension, zero biases, as the JAX ``init_params``."""

    def dense(shape):
        return (torch.randn(shape, generator=generator) / np.sqrt(shape[0])).numpy()

    params: dict = {"layers": []}
    d = input_dim
    for _ in range(layers):
        params["layers"].append({
            direction: {"W": dense((d, 4 * hidden)), "U": dense((hidden, 4 * hidden)), "b": np.zeros((4 * hidden,), np.float32)}
            for direction in ("fwd", "bwd")})
        d = 2 * hidden
    params["out_w"] = dense((d, 1))
    params["out_b"] = np.zeros((1,), np.float32)
    return params


def params_of(net: BeatBLSTM, template: dict) -> dict:
    """One member's weights as a JAX pytree in ``template``'s layout."""
    return convert.to_pytree(convert.beat_blstm_state, template, net.state_dict())


def _flatten(params: dict, prefix: str = "") -> dict[str, np.ndarray]:
    flat = {}
    for i, layer in enumerate(params["layers"]):
        for d in ("fwd", "bwd"):
            for k in ("W", "U", "b"):
                flat[f"{prefix}l{i}_{d}_{k}"] = np.asarray(layer[d][k])
    flat[f"{prefix}out_w"] = np.asarray(params["out_w"])
    flat[f"{prefix}out_b"] = np.asarray(params["out_b"])
    for k in ("feat_mean", "feat_std", "full_context"):
        if k in params:
            flat[f"{prefix}{k}"] = np.asarray(params[k])
    return flat


def save_params(path: str, params: dict) -> None:
    """The JAX ``save_params`` layout: a flat npz, extra "ensemble" members
    under m1_/m2_/… prefixes (the inverse of load_params)."""
    flat = _flatten(params)
    for j, member in enumerate(params.get("ensemble", []), start=1):
        flat.update(_flatten(member, prefix=f"m{j}_"))
    np.savez(path, **flat)


def onset_activation(y: torch.Tensor, sr: int, fps: int = FPS_DEFAULT) -> torch.Tensor:
    """Spectral-flux beat activation [T] at ``fps``, normalised to [0, 1]:
    the weight-free default of the JAX package.

    Band energies come from the CQT GEMM (6 bands per octave over the madmom
    frequency range); the mean positive log-band flux is smoothed by a 3-tap
    triangle and normalised by its 25th and 99th percentiles (linear
    interpolation, as jnp.percentile)."""
    hop = sr // fps
    n_bins = int(np.floor(_BANDS_PER_OCTAVE * np.log2(_FMAX / _FMIN)))
    n_bins = min(n_bins, int(np.floor(_BANDS_PER_OCTAVE * np.log2((sr / 2.0 - 1) / _FMIN))))
    C = cqt(y, sr, hop=hop, fmin=_FMIN, n_bins=n_bins, bins_per_octave=_BANDS_PER_OCTAVE, max_kernel_len=2048)  # [B, T]
    logb = torch.log10(1.0 + 5.0 * C)
    diff = torch.clamp(logb[:, 1:] - logb[:, :-1], min=0.0)
    act = F.pad(diff.mean(dim=0), (1, 0))
    kernel = uploaded(torch.tensor([[[0.25, 0.5, 0.25]]], dtype=act.dtype, device=act.device))
    act = F.conv1d(act[None, None], kernel, padding=1)[0, 0]  # jnp.convolve(mode="same")
    act = torch.clamp(act - torch.quantile(act, 0.25), min=0.0)
    denom = torch.quantile(act, 0.99) + 1e-8
    return torch.clamp(act / denom, 0.0, 1.0)


def ensemble_from_params(params: dict) -> list[BeatBLSTM]:
    """A pytree with optional "ensemble" members → one module per member."""
    members = [{k: v for k, v in params.items() if k != "ensemble"}, *params.get("ensemble", [])]
    return [BeatBLSTM.from_params(m).eval() for m in members]


def beat_activation(y: torch.Tensor, sr: int, ensemble: list[BeatBLSTM], fps: int = FPS_DEFAULT) -> torch.Tensor:
    """Beat activation [T]: the mean of every ensemble member's activation,
    or ``onset_activation`` when the ensemble is empty (no checkpoint).

    A member flagged full_context runs the whole sequence in one pass (its
    backward LSTM sees the whole song); the others run chunked."""
    if not ensemble:
        return onset_activation(y, sr, fps)
    feats = spectral_features(y, sr, fps)
    acts = [blstm_apply(m, feats) if m.full_context else blstm_apply_chunked(m, feats) for m in ensemble]
    return torch.stack(acts).mean(dim=0)
