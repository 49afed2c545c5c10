"""htdemucs source separation (counterpart of audiotabs_tpu/models/htdemucs.py).

``HTDemucs`` is the hybrid transformer as an nn.Module whose widths come from
the checkpoint's shapes (the checked-in ``htdemucs_6s`` checkpoint is 24
channels, a 192-wide bottom and 3 transformer layers, not the published
48/512/5): a spectral branch (STFT 4096/1024 as complex-as-channels, four
frequency-strided conv encoders, each with a dilated residual DConv along
time), a time branch (four stride-4 conv1d encoders), a cross-domain
transformer (even layers cross-attend between the branches, odd layers
self-attend; pre-norm, LayerScale, GroupNorm over all of a layer's tokens),
and mirrored transposed-conv decoders whose outputs are denormalised, the
spectral one through the iSTFT, and summed. ``forward`` takes a batch of
windows [B, 2, L], the JAX ``vmap`` written out.

``separate_program`` is the JAX ``_separate_program``: 2x upsampling to the
model rate as frame @ banded matrix, pseudo-stereo, deterministic shift
offsets, fixed windows run through the net in chunks of ``_FWD_CHUNK``, one
triangular-weighted overlap-add, the mono mean and 2x decimation. Its stems
stay on the input's device.

Normalisation statistics (GroupNorm, LayerNorm) and the attention softmax are
computed in float32 and GELU is exact. ``bf16=True`` (``DEMUCS_BF16``) runs
the net under bf16 autocast; the STFT/iSTFT, input normalisation, softmax,
resampling and overlap-add stay float32. Attention is matmul + softmax, as the
JAX package writes it (no Pallas kernel there, so none here).
"""

from __future__ import annotations

import math
import os
from functools import lru_cache

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.spectral import _pad_last, istft, stft
from . import convert
from .params_io import load_pytree_npz, save_pytree_npz, weights_path

MODEL_STEMS = {
    "htdemucs": ("drums", "bass", "other", "vocals"),
    "htdemucs_ft": ("drums", "bass", "other", "vocals"),
    "htdemucs_6s": ("drums", "bass", "other", "vocals", "guitar", "piano"),
}

NFFT = 4096
HOP = 1024
DEPTH = 4
KERNEL = 8
STRIDE = 4
T_HEADS = 8
FREQ_EMB_SCALE = 0.2
SEGMENT_SEC = 7.8
OVERLAP = 0.25
MODEL_SR = 44100
ALIGN = 1024  # segment lengths are multiples of this
CHANNELS = 48  # the published sizing, init_params' defaults
GROWTH = 2
T_LAYERS = 5
BOTTOM_CHANNELS = 512
DCONV_COMP = 8  # dconv hidden = channels // 8
_FWD_CHUNK = 16  # windows per batched forward inside separate_program


# ------------------------------------------------- sinusoidal embeddings ---


def create_sin_embedding(length: int, dim: int, max_period: float = 10000.0) -> np.ndarray:
    """demucs 1-D sinusoidal embedding: [length, dim] = [cos | sin]."""
    pos = np.arange(length, dtype=np.float64)[:, None]
    half = dim // 2
    adim = np.arange(half, dtype=np.float64)[None, :]
    phase = pos / (max_period ** (adim / max(half - 1, 1)))
    return np.concatenate([np.cos(phase), np.sin(phase)], axis=-1).astype(np.float32)


def create_2d_sin_embedding(d_model: int, height: int, width: int, max_period: float = 10000.0) -> np.ndarray:
    """demucs 2-D sinusoidal embedding → [d_model, height, width]."""
    if d_model % 4 != 0:
        raise ValueError("d_model must be divisible by 4")
    pe = np.zeros((d_model, height, width), dtype=np.float64)
    half = d_model // 2
    div_term = np.exp(np.arange(0.0, half, 2) * -(math.log(max_period) / half))
    pos_w = np.arange(width, dtype=np.float64)[:, None]
    pos_h = np.arange(height, dtype=np.float64)[:, None]
    pe[0:half:2] = np.sin(pos_w * div_term).T[:, None, :].repeat(height, axis=1)
    pe[1:half:2] = np.cos(pos_w * div_term).T[:, None, :].repeat(height, axis=1)
    pe[half::2] = np.sin(pos_h * div_term).T[:, :, None].repeat(width, axis=2)
    pe[half + 1 :: 2] = np.cos(pos_h * div_term).T[:, :, None].repeat(width, axis=2)
    return pe.astype(np.float32)


@lru_cache(maxsize=8)
def _embeddings(d: int, fq: int, ts: int, tt: int, device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """(2-D embedding of the spectral tokens in "(t f) c" order [ts*fq, d],
    1-D embedding of the time tokens [tt, d]) on ``device``, built once."""
    pe2 = create_2d_sin_embedding(d, fq, ts).transpose(2, 1, 0).reshape(ts * fq, d)
    with torch.inference_mode(False):
        return torch.from_numpy(np.ascontiguousarray(pe2)).to(device), torch.from_numpy(create_sin_embedding(tt, d)).to(device)


# ------------------------------------------------------------------ layers --


class GroupNorm32(nn.GroupNorm):
    """GroupNorm(1, C) over (C, T) per sample, statistics in float32."""

    def __init__(self, channels: int):
        super().__init__(1, channels, eps=1e-5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.group_norm(x.float(), 1, self.weight, self.bias, self.eps).to(x.dtype)


class TokenGroupNorm32(GroupNorm32):
    """GroupNorm(1, D) on tokens [B, N, D]: normalise over all of (N, D) per sample."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x.transpose(1, 2)).transpose(1, 2)


class LayerNorm32(nn.LayerNorm):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x.float(), self.normalized_shape, self.weight, self.bias, self.eps).to(x.dtype)


class DConvBlock(nn.Module):
    """Dilated conv → GroupNorm → GELU → 1×1 conv → GroupNorm → GLU, LayerScale residual."""

    def __init__(self, channels: int, hidden: int, dilation: int):
        super().__init__()
        self.conv1 = nn.Conv1d(channels, hidden, 3, dilation=dilation, padding=dilation)
        self.gn1 = GroupNorm32(hidden)
        self.conv2 = nn.Conv1d(hidden, 2 * channels, 1)
        self.gn2 = GroupNorm32(2 * channels)
        self.scale = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.gelu(self.gn1(self.conv1(x)))
        h = F.glu(self.gn2(self.conv2(h)), dim=1)
        return x + self.scale[:, None] * h


class DConv(nn.Module):
    def __init__(self, channels: int, hidden: int, depth: int = 2):
        super().__init__()
        self.layers = nn.ModuleList(DConvBlock(channels, hidden, 2**j) for j in range(depth))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for blk in self.layers:
            x = blk(x)
        return x


class EncFreq(nn.Module):
    """[B, C_in, F, T] → [B, C, F/4, T]; the DConv runs along time with frequency folded into the batch."""

    def __init__(self, c_in: int, c: int, hidden: int):
        super().__init__()
        self.conv = nn.Conv2d(c_in, c, (KERNEL, 1), stride=(STRIDE, 1), padding=(2, 0))
        self.dconv = DConv(c, hidden)
        self.rewrite = nn.Conv2d(c, 2 * c, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.gelu(self.conv(x))
        B, C, Fq, T = y.shape
        yb = self.dconv(y.permute(0, 2, 1, 3).reshape(B * Fq, C, T))
        y = yb.reshape(B, Fq, C, T).permute(0, 2, 1, 3)
        return F.glu(self.rewrite(y), dim=1)


class EncTime(nn.Module):
    """[B, C_in, T] → [B, C, T/4]."""

    def __init__(self, c_in: int, c: int, hidden: int):
        super().__init__()
        self.conv = nn.Conv1d(c_in, c, KERNEL, stride=STRIDE, padding=2)
        self.dconv = DConv(c, hidden)
        self.rewrite = nn.Conv1d(c, 2 * c, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.glu(self.rewrite(self.dconv(F.gelu(self.conv(x)))), dim=1)


def _conv3x3(x: torch.Tensor, conv: nn.Conv2d) -> torch.Tensor:
    """A 3×3 convolution (padding 1) as im2col and one matrix product.

    cuDNN's float32 heuristics (TF32 off) take an FFT-tiling algorithm for
    the decoder's bottom inputs: on an H100, hundreds of ms and tens of GB of
    workspace for [14, 192, 8, 128], against under 1 ms this way
    (scripts/htdemucs_conv_algos.py; PERF.md)."""
    B, _, H, W = x.shape
    cols = F.unfold(x, 3, padding=1)  # [B, C * 9, H * W], rows ordered (c, kh, kw) as the weight
    out = conv.weight.reshape(conv.out_channels, -1) @ cols + conv.bias[:, None]
    return out.reshape(B, -1, H, W)


class DecFreq(nn.Module):
    """(x + skip) [B, C, F, T] → 3×3 rewrite, GLU → transposed conv over frequency, trimmed by 2 → [B, C_out, 4F, T]."""

    def __init__(self, c: int, c_out: int, last: bool):
        super().__init__()
        self.rewrite = nn.Conv2d(c, 2 * c, 3, padding=1)
        self.convtr = nn.ConvTranspose2d(c, c_out, (KERNEL, 1), stride=(STRIDE, 1))
        self.last = last

    def forward(self, x: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
        z = self.convtr(F.glu(_conv3x3(x + skip, self.rewrite), dim=1))[:, :, 2:-2]
        return z if self.last else F.gelu(z)


class DecTime(nn.Module):
    """(x + skip) [B, C, T] → rewrite (kernel 3), GLU → transposed conv, trimmed by 2 → [B, C_out, 4T]."""

    def __init__(self, c: int, c_out: int, last: bool):
        super().__init__()
        self.rewrite = nn.Conv1d(c, 2 * c, 3, padding=1)
        self.convtr = nn.ConvTranspose1d(c, c_out, KERNEL, stride=STRIDE)
        self.last = last

    def forward(self, x: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
        z = self.convtr(F.glu(self.rewrite(x + skip), dim=1))[..., 2:-2]
        return z if self.last else F.gelu(z)


class TransformerLayer(nn.Module):
    """Pre-norm attention + feed-forward with LayerScale and a GroupNorm over all tokens.

    A cross layer takes its queries from norm1(x) and its keys and values from
    norm2(other), and norms the feed-forward input with norm3; a self layer
    attends over norm1(x) and norms the feed-forward input with norm2."""

    def __init__(self, d: int, ff: int, cross: bool, heads: int = T_HEADS):
        super().__init__()
        self.cross, self.heads = cross, heads
        self.q, self.k, self.v, self.o = (nn.Linear(d, d) for _ in range(4))
        self.norm1, self.norm2 = LayerNorm32(d), LayerNorm32(d)
        if cross:
            self.norm3 = LayerNorm32(d)
        self.lin1, self.lin2 = nn.Linear(d, ff), nn.Linear(ff, d)
        self.gamma1 = nn.Parameter(torch.zeros(d))
        self.gamma2 = nn.Parameter(torch.zeros(d))
        self.normout = TokenGroupNorm32(d)

    def _mha(self, q_in: torch.Tensor, kv_in: torch.Tensor) -> torch.Tensor:
        B, Nq, D = q_in.shape
        hd = D // self.heads

        def heads(t: torch.Tensor) -> torch.Tensor:
            return t.reshape(B, -1, self.heads, hd).transpose(1, 2)  # [B, H, N, hd]

        q, k, v = heads(self.q(q_in)), heads(self.k(kv_in)), heads(self.v(kv_in))
        logits = (q @ k.transpose(-1, -2)).float() / math.sqrt(hd)
        att = torch.softmax(logits, dim=-1).to(q.dtype)  # softmax in float32
        return self.o((att @ v).transpose(1, 2).reshape(B, Nq, D))

    def forward(self, x: torch.Tensor, other: torch.Tensor | None = None) -> torch.Tensor:
        if self.cross:
            x = x + self.gamma1 * self._mha(self.norm1(x), self.norm2(other))
            h = self.norm3(x)
        else:
            h = self.norm1(x)
            x = x + self.gamma1 * self._mha(h, h)
            h = self.norm2(x)
        x = x + self.gamma2 * self.lin2(F.gelu(self.lin1(h)))
        return self.normout(x)


# ------------------------------------------------------------- spec ---------


def _spec(x: torch.Tensor, length: int) -> torch.Tensor:
    """demucs _spec: x [..., L] → complex [..., 2048, ceil(L/HOP)]."""
    le = -(-length // HOP)
    pad = HOP // 2 * 3
    x = _pad_last(x, pad, pad + le * HOP - length, "reflect")
    z = stft(x, n_fft=NFFT, hop=HOP)  # centred → [..., 2049, T']
    return z[..., :-1, 2 : 2 + le]


def _ispec(z: torch.Tensor, length: int) -> torch.Tensor:
    """demucs _ispec: complex [..., 2048, T] → [..., length]."""
    z = F.pad(z, (2, 2, 0, 1))  # Nyquist row, 2 frames each side
    pad = HOP // 2 * 3
    le = HOP * int(math.ceil(length / HOP)) + 2 * pad
    return istft(z, hop=HOP, length=le)[..., pad : pad + length]


# ------------------------------------------------------------- full model --


class HTDemucs(nn.Module):
    def __init__(self, chans: list[int], hidden: list[tuple[int, int]], n_sources: int, audio_channels: int,
                 bottom: int, t_ff: int, t_layers: int, freq_emb_rows: int):
        super().__init__()
        self.n_sources, self.audio_channels = n_sources, audio_channels
        spec_in = 2 * audio_channels
        self.encoder = nn.ModuleList(EncFreq(spec_in if d == 0 else chans[d - 1], chans[d], hidden[d][0]) for d in range(DEPTH))
        self.tencoder = nn.ModuleList(EncTime(audio_channels if d == 0 else chans[d - 1], chans[d], hidden[d][1]) for d in range(DEPTH))
        rev = list(reversed(range(DEPTH)))
        self.decoder = nn.ModuleList(
            DecFreq(chans[d], n_sources * spec_in if d == 0 else chans[d - 1], last=d == 0) for d in rev)
        self.tdecoder = nn.ModuleList(
            DecTime(chans[d], n_sources * audio_channels if d == 0 else chans[d - 1], last=d == 0) for d in rev)
        self.freq_emb = nn.Parameter(torch.zeros(freq_emb_rows, chans[0]))  # the embedding times its scale of 10
        dim = chans[-1]
        self.up_s, self.up_t = nn.Linear(dim, bottom), nn.Linear(dim, bottom)
        self.down_s, self.down_t = nn.Linear(bottom, dim), nn.Linear(bottom, dim)
        self.norm_in, self.norm_in_t = LayerNorm32(bottom), LayerNorm32(bottom)
        self.tlayers = nn.ModuleList(TransformerLayer(bottom, t_ff, cross=i % 2 == 0) for i in range(t_layers))
        self.tlayers_t = nn.ModuleList(TransformerLayer(bottom, t_ff, cross=i % 2 == 0) for i in range(t_layers))

    @classmethod
    def from_params(cls, params: dict) -> "HTDemucs":
        """Build from a JAX-layout pytree; every width is read off its arrays."""
        enc, tenc = params["encoder"], params["tencoder"]

        def hid(layer: dict) -> int:
            return np.asarray(layer["dconv"]["blocks"][0]["conv1_w"]).shape[0]

        audio_channels = np.asarray(tenc[0]["conv_w"]).shape[1]
        net = cls(
            chans=[np.asarray(e["conv_w"]).shape[0] for e in enc],
            hidden=[(hid(e), hid(t)) for e, t in zip(enc, tenc)],
            n_sources=np.asarray(params["tdecoder"][-1]["convtr_w"]).shape[1] // audio_channels,
            audio_channels=audio_channels,
            bottom=np.asarray(params["up_s_w"]).shape[0],
            t_ff=np.asarray(params["tlayers"][0]["lin1_w"]).shape[1],
            t_layers=len(params["tlayers"]),
            freq_emb_rows=np.asarray(params["freq_emb"]).shape[0],
        )
        net.load_state_dict(convert.htdemucs_state(params))
        return net.requires_grad_(False).eval()

    def _net(self, x: torch.Tensor, xt: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """Normalised spectrogram [B, 2ch, F, T] and waveform [B, ch, L] → both branches' decoder outputs."""
        saved, saved_t = [], []
        for i in range(DEPTH):
            xt = self.tencoder[i](xt)
            saved_t.append(xt)
            x = self.encoder[i](x)
            if i == 0:
                x = x + FREQ_EMB_SCALE * self.freq_emb[: x.shape[2]].T[None, :, :, None]
            saved.append(x)

        B, C, Fq, Ts = x.shape
        tok_s = self.up_s(x.permute(0, 3, 2, 1).reshape(B, Ts * Fq, C))  # time-major "(t f) c"
        tok_t = self.up_t(xt.transpose(1, 2))
        pe2, pe1 = _embeddings(tok_s.shape[-1], Fq, Ts, tok_t.shape[1], x.device)
        tok_s = self.norm_in(tok_s) + pe2.to(tok_s.dtype)
        tok_t = self.norm_in_t(tok_t) + pe1.to(tok_t.dtype)
        for ls, lt in zip(self.tlayers, self.tlayers_t):
            if ls.cross:  # both cross layers read the other branch's tokens from before this layer
                tok_s, tok_t = ls(tok_s, tok_t), lt(tok_t, tok_s)
            else:
                tok_s, tok_t = ls(tok_s), lt(tok_t)
        x = self.down_s(tok_s).reshape(B, Ts, Fq, C).permute(0, 3, 2, 1)
        xt = self.down_t(tok_t).transpose(1, 2)

        for i in range(DEPTH):
            x = self.decoder[i](x, saved[DEPTH - 1 - i])
            xt = self.tdecoder[i](xt, saved_t[DEPTH - 1 - i])
        return x, xt

    def forward(self, mix: torch.Tensor, bf16: bool = False) -> torch.Tensor:
        """mix [B, ch, L] (or [ch, L]) → stems [B, S, ch, L] (or [S, ch, L]); L a multiple of ALIGN.

        Each window is normalised by its own mean and std (``correction=1``,
        the JAX ``std(ddof=1)``)."""
        single = mix.dim() == 2
        mix = mix[None] if single else mix
        B, ch, L = mix.shape
        S = self.n_sources
        z = _spec(mix, L)  # [B, ch, F, T]
        Fr, T = z.shape[-2:]
        mag = torch.stack([z.real, z.imag], dim=2).reshape(B, 2 * ch, Fr, T)  # channel-major, re/im minor
        mean = mag.mean(dim=(1, 2, 3), keepdim=True)
        std = mag.std(dim=(1, 2, 3), keepdim=True)
        meant = mix.mean(dim=(1, 2), keepdim=True)
        stdt = mix.std(dim=(1, 2), keepdim=True)
        with torch.autocast(mix.device.type, dtype=torch.bfloat16, enabled=bf16):
            x, xt = self._net((mag - mean) / (1e-5 + std), (mix - meant) / (1e-5 + stdt))
        x = x.float().reshape(B, S, 2 * ch, Fr, T) * std[:, None] + mean[:, None]
        zout = x.reshape(B, S, ch, 2, Fr, T)
        wav_spec = _ispec(torch.complex(zout[:, :, :, 0], zout[:, :, :, 1]), L)  # [B, S, ch, L]
        wav_time = xt.float().reshape(B, S, ch, L) * stdt[:, None] + meant[:, None]
        out = wav_spec + wav_time
        return out[0] if single else out


# ------------------------------------------------------------ random init --


def init_params(generator: torch.Generator, n_sources: int = 4, audio_channels: int = 2, channels: int = CHANNELS,
                bottom: int = BOTTOM_CHANNELS, t_layers: int = T_LAYERS, t_ff: int | None = None) -> dict:
    """Random init of the JAX pytree (numpy, JAX layout), as the JAX
    ``init_params``: the same shapes, He scaling (``sqrt(2 / fan_in)``, the
    transposed convs with fan-in ``ci * KERNEL``), zero biases, unit norms,
    LayerScale at 1e-3 (dconv) and 1e-4 (transformer) and the sinusoidal
    frequency embedding. Every He weight comes from one draw of
    ``generator`` on its own device (the card's generator draws on the
    card), scaled there and copied to the host once."""
    t_ff = t_ff or 4 * bottom
    draws: list[tuple[tuple[int, ...], float]] = []  # (shape, std) of each He weight, in the order drawn

    def he(shape, fan_in=None):
        fan_in = fan_in or int(np.prod(shape[1:]))
        draws.append((tuple(shape), math.sqrt(2.0 / fan_in)))
        return len(draws) - 1  # a placeholder for the draw, filled in below

    def zeros(n):
        return np.zeros((n,), np.float32)

    def ones(n):
        return np.ones((n,), np.float32)

    def dconv_init(ch):
        hid = max(4, ch // DCONV_COMP)
        return {"blocks": [
            {"conv1_w": he((hid, ch, 3)), "conv1_b": zeros(hid), "gn1_g": ones(hid), "gn1_b": zeros(hid),
             "conv2_w": he((2 * ch, hid, 1)), "conv2_b": zeros(2 * ch), "gn2_g": ones(2 * ch), "gn2_b": zeros(2 * ch),
             "scale": np.full((ch,), 1e-3, np.float32)}
            for _ in range(2)]}

    chans = [channels * GROWTH**i for i in range(DEPTH)]
    spec_in = 2 * audio_channels
    p: dict = {"encoder": [], "tencoder": [], "decoder": [], "tdecoder": []}
    c_s, c_t = spec_in, audio_channels
    for d in range(DEPTH):
        co = chans[d]
        p["encoder"].append({"conv_w": he((co, c_s, KERNEL, 1)), "conv_b": zeros(co),
                             "rewrite_w": he((2 * co, co, 1, 1)), "rewrite_b": zeros(2 * co), "dconv": dconv_init(co)})
        p["tencoder"].append({"conv_w": he((co, c_t, KERNEL)), "conv_b": zeros(co),
                              "rewrite_w": he((2 * co, co, 1)), "rewrite_b": zeros(2 * co), "dconv": dconv_init(co)})
        c_s = c_t = co
    for d in reversed(range(DEPTH)):
        ci = chans[d]
        co_s = n_sources * spec_in if d == 0 else chans[d - 1]
        co_t = n_sources * audio_channels if d == 0 else chans[d - 1]
        p["decoder"].append({"rewrite_w": he((2 * ci, ci, 3, 3)), "rewrite_b": zeros(2 * ci),
                             "convtr_w": he((ci, co_s, KERNEL, 1), fan_in=ci * KERNEL), "convtr_b": zeros(co_s)})
        p["tdecoder"].append({"rewrite_w": he((2 * ci, ci, 3)), "rewrite_b": zeros(2 * ci),
                              "convtr_w": he((ci, co_t, KERNEL), fan_in=ci * KERNEL), "convtr_b": zeros(co_t)})
    p["freq_emb"] = create_sin_embedding(NFFT // 2 // STRIDE, chans[0], max_period=10000.0)

    dim, D = chans[-1], bottom
    for side in ("s", "t"):
        p[f"up_{side}_w"], p[f"up_{side}_b"] = he((D, dim)), zeros(D)
    for side in ("s", "t"):
        p[f"down_{side}_w"], p[f"down_{side}_b"] = he((dim, D)), zeros(dim)
    p["norm_in_g"], p["norm_in_b"] = ones(D), zeros(D)
    p["norm_in_t_g"], p["norm_in_t_b"] = ones(D), zeros(D)

    def tlayer_init(cross: bool) -> dict:
        lp = {"q_w": he((D, D)), "k_w": he((D, D)), "v_w": he((D, D)), "o_w": he((D, D)),
              "q_b": zeros(D), "k_b": zeros(D), "v_b": zeros(D), "o_b": zeros(D),
              "norm1_g": ones(D), "norm1_b": zeros(D), "norm2_g": ones(D), "norm2_b": zeros(D),
              "lin1_w": he((D, t_ff)), "lin1_b": zeros(t_ff), "lin2_w": he((t_ff, D)), "lin2_b": zeros(D),
              "gamma1": np.full((D,), 1e-4, np.float32), "gamma2": np.full((D,), 1e-4, np.float32),
              "normout_g": ones(D), "normout_b": zeros(D)}
        if cross:
            lp["norm3_g"], lp["norm3_b"] = ones(D), zeros(D)
        return lp

    p["tlayers"] = [tlayer_init(cross=i % 2 == 0) for i in range(t_layers)]
    p["tlayers_t"] = [tlayer_init(cross=i % 2 == 0) for i in range(t_layers)]

    sizes = [math.prod(shape) for shape, _ in draws]
    z = torch.randn(sum(sizes), generator=generator, device=generator.device)
    z *= torch.tensor([std for _, std in draws], device=z.device).repeat_interleave(torch.tensor(sizes, device=z.device))
    flat = np.split(z.cpu().numpy(), np.cumsum(sizes)[:-1])
    weights = [w.reshape(shape) for w, (shape, _) in zip(flat, draws)]

    def fill(node):
        if isinstance(node, dict):
            return {k: fill(v) for k, v in node.items()}
        if isinstance(node, list):
            return [fill(v) for v in node]
        return weights[node] if isinstance(node, int) else node

    return fill(p)


def params_of(net: HTDemucs, template: dict) -> dict:
    """The module's weights as a JAX pytree in ``template``'s layout (its
    ``meta_segment`` kept): the inverse of ``from_params``."""
    return convert.to_pytree(convert.htdemucs_state, template, net.state_dict())


def save_params(path: str, params: dict) -> None:
    """Write a pytree as the JAX package's flat path-keyed npz
    (``save_pytree_npz``), and drop what the loaders cached by path, so a
    later load in this process reads the file just written."""
    save_pytree_npz(path, params)
    _load_npz.cache_clear()
    _model.cache_clear()


def _strip_prefix(state_dict: dict) -> dict:
    """Accept BagOfModels-style checkpoints ('models.0.' prefixed keys)."""
    for pref in ("models.0.", "model.", "module."):
        if any(k.startswith(pref) for k in state_dict):
            return {k[len(pref) :]: v for k, v in state_dict.items() if k.startswith(pref)}
    return state_dict


def convert_torch_state_dict(state_dict: dict, audio_channels: int = 2) -> dict:
    """A released HTDemucs checkpoint's state dict (upstream key naming,
    ``models.0.`` prefix stripped) → the JAX-layout pytree that
    ``HTDemucs.from_params`` loads; raises ``KeyError`` on a missing key.

    Counterpart of the JAX ``convert_torch_state_dict``: tensors or numpy
    arrays; Linear and attention weights transposed to the ``x @ W``
    layout, conv weights in torch's layout, the embedding times its scale
    of 10. ``audio_channels`` is read off the weights, as there."""
    sd = {k: (v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v))
          for k, v in _strip_prefix(state_dict).items()}

    def arr(key):
        if key not in sd:
            raise KeyError(f"missing checkpoint key: {key}")
        return sd[key]

    def dconv_params(prefix):
        blocks = []
        for j in range(2):
            b = f"{prefix}.layers.{j}"
            blocks.append({
                "conv1_w": arr(f"{b}.0.weight"), "conv1_b": arr(f"{b}.0.bias"),
                "gn1_g": arr(f"{b}.1.weight"), "gn1_b": arr(f"{b}.1.bias"),
                "conv2_w": arr(f"{b}.3.weight"), "conv2_b": arr(f"{b}.3.bias"),
                "gn2_g": arr(f"{b}.4.weight"), "gn2_b": arr(f"{b}.4.bias"),
                "scale": arr(f"{b}.6.scale"),
            })
        return {"blocks": blocks}

    p: dict = {"encoder": [], "tencoder": [], "decoder": [], "tdecoder": []}
    for i in range(DEPTH):
        for ours in ("encoder", "tencoder"):
            p[ours].append({
                "conv_w": arr(f"{ours}.{i}.conv.weight"), "conv_b": arr(f"{ours}.{i}.conv.bias"),
                "rewrite_w": arr(f"{ours}.{i}.rewrite.weight"), "rewrite_b": arr(f"{ours}.{i}.rewrite.bias"),
                "dconv": dconv_params(f"{ours}.{i}.dconv"),
            })
        for ours in ("decoder", "tdecoder"):
            p[ours].append({
                "rewrite_w": arr(f"{ours}.{i}.rewrite.weight"), "rewrite_b": arr(f"{ours}.{i}.rewrite.bias"),
                "convtr_w": arr(f"{ours}.{i}.conv_tr.weight"), "convtr_b": arr(f"{ours}.{i}.conv_tr.bias"),
            })

    # ScaledEmbedding: effective embedding = weight * scale (scale=10)
    p["freq_emb"] = arr("freq_emb.embedding.weight") * np.float32(10.0)
    for ours, theirs in (("up_s", "channel_upsampler"), ("up_t", "channel_upsampler_t"),
                         ("down_s", "channel_downsampler"), ("down_t", "channel_downsampler_t")):
        p[f"{ours}_w"] = arr(f"{theirs}.weight")[:, :, 0]  # Conv1d 1×1 [out, in, 1]
        p[f"{ours}_b"] = arr(f"{theirs}.bias")
    p["norm_in_g"] = arr("crosstransformer.norm_in.weight")
    p["norm_in_b"] = arr("crosstransformer.norm_in.bias")
    p["norm_in_t_g"] = arr("crosstransformer.norm_in_t.weight")
    p["norm_in_t_b"] = arr("crosstransformer.norm_in_t.bias")

    def tlayer_params(prefix, cross: bool):
        attn = "cross_attn" if cross else "self_attn"
        in_w = arr(f"{prefix}.{attn}.in_proj_weight")  # [3D, D]
        in_b = arr(f"{prefix}.{attn}.in_proj_bias")
        D = in_w.shape[1]
        lp = {
            "q_w": in_w[:D].T, "k_w": in_w[D : 2 * D].T, "v_w": in_w[2 * D :].T,
            "q_b": in_b[:D], "k_b": in_b[D : 2 * D], "v_b": in_b[2 * D :],
            "o_w": arr(f"{prefix}.{attn}.out_proj.weight").T, "o_b": arr(f"{prefix}.{attn}.out_proj.bias"),
            "norm1_g": arr(f"{prefix}.norm1.weight"), "norm1_b": arr(f"{prefix}.norm1.bias"),
            "norm2_g": arr(f"{prefix}.norm2.weight"), "norm2_b": arr(f"{prefix}.norm2.bias"),
            "lin1_w": arr(f"{prefix}.linear1.weight").T, "lin1_b": arr(f"{prefix}.linear1.bias"),
            "lin2_w": arr(f"{prefix}.linear2.weight").T, "lin2_b": arr(f"{prefix}.linear2.bias"),
            "gamma1": arr(f"{prefix}.gamma_1.scale"), "gamma2": arr(f"{prefix}.gamma_2.scale"),
            "normout_g": arr(f"{prefix}.norm_out.weight"), "normout_b": arr(f"{prefix}.norm_out.bias"),
        }
        if cross:
            lp["norm3_g"] = arr(f"{prefix}.norm3.weight")
            lp["norm3_b"] = arr(f"{prefix}.norm3.bias")
        return lp

    p["tlayers"] = [tlayer_params(f"crosstransformer.layers.{i}", cross=i % 2 == 0) for i in range(T_LAYERS)]
    p["tlayers_t"] = [tlayer_params(f"crosstransformer.layers_t.{i}", cross=i % 2 == 0) for i in range(T_LAYERS)]
    return p


# -------------------------------------------------- the separation program --


def _halfband_fir(taps: int = 129, beta: float = 8.0) -> np.ndarray:
    """Windowed-sinc half-band lowpass (cutoff = Nyquist/2) for exact 2x resampling."""
    n = np.arange(taps) - taps // 2
    h = np.sinc(n / 2.0) / 2.0
    h *= np.kaiser(taps, beta)
    return (h / h.sum()).astype(np.float32)


def _resample2_mats(taps: int = 129) -> tuple[np.ndarray, np.ndarray]:
    """Banded polyphase matrices: Wd [384, 128] maps a 384-sample frame (hop
    256) of the 44.1 kHz signal, padded 64 on the left, to 128 samples at
    22.05 kHz; Wu [192, 256] maps a 192-sample frame (hop 128) of the
    22.05 kHz signal, padded 32 on the left, to 256 samples at 44.1 kHz."""
    h = _halfband_fir(taps)
    Wd = np.zeros((384, 128), np.float32)
    for n in range(128):
        Wd[2 * n : 2 * n + taps, n] = h
    Wu = np.zeros((192, 256), np.float32)
    for j in range(192):
        for n in range(max(0, 2 * j - taps + 1), min(256, 2 * j + 1)):
            Wu[j, n] = 2.0 * h[2 * j - n]
    return Wd, Wu


@lru_cache(maxsize=4)
def _resample_mats(device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    with torch.inference_mode(False):
        return tuple(torch.from_numpy(m).to(device) for m in _resample2_mats())


def _down2(x: torch.Tensor) -> torch.Tensor:
    """[..., 2L] → [..., L]: half-band decimation as frame @ banded matrix."""
    L = x.shape[-1] // 2
    M = -(-L // 128)
    need = (M - 1) * 256 + 384
    xp = F.pad(x, (64, max(0, need - x.shape[-1] - 64)))
    out = xp.unfold(-1, 384, 256)[..., :M, :] @ _resample_mats(x.device)[0]
    return out.reshape(*x.shape[:-1], M * 128)[..., :L]


def _up2(x: torch.Tensor) -> torch.Tensor:
    """[..., L] → [..., 2L]: zero-stuffing and half-band interpolation as frame @ banded matrix."""
    L = x.shape[-1]
    M = -(-(2 * L) // 256)
    need = (M - 1) * 128 + 192
    xp = F.pad(x, (32, max(0, need - L - 32)))
    out = xp.unfold(-1, 192, 128)[..., :M, :] @ _resample_mats(x.device)[1]
    return out.reshape(*x.shape[:-1], M * 256)[..., : 2 * L]


def _segment_windows(length: int, seg: int, stride: int) -> list[int]:
    return list(range(0, max(1, length - seg + stride), stride))


def _triangle(seg: int, device: torch.device) -> torch.Tensor:
    return torch.cat([torch.linspace(0.1, 1.0, seg // 2, device=device), torch.linspace(1.0, 0.1, seg - seg // 2, device=device)])


def separate_program(model: HTDemucs, y: torch.Tensor, sr: int, seg: int, stride: int, shifts: int,
                     bf16: bool = False) -> torch.Tensor:
    """y [L] or a batch of songs [B, L], mono at sr (MODEL_SR or MODEL_SR // 2)
    → stems [n_sources, L] or [B, n_sources, L] on y's device.

    The windows of every song go through the net together, ``_FWD_CHUNK`` at
    a time (the JAX batch runner vmaps the one-song program instead); each
    song's overlap-add is the one-song order, so a row of a batch is the
    one-song result up to the GEMM blocking of the net."""
    single = y.dim() == 1
    y44 = y if sr == MODEL_SR else _up2(y)
    y44 = y44[None] if single else y44
    n_songs, L44 = y44.shape
    mix = torch.stack([y44, y44], dim=1)  # pseudo-stereo [B, 2, L44]

    # deterministic shift offsets, as the JAX program
    max_shift = int(0.5 * MODEL_SR)
    shift_offs = [0] + [(i * max_shift) // shifts for i in range(1, max(1, shifts))]
    windows, metas = [], []
    for soff in shift_offs:
        offs = _segment_windows(L44 + soff, seg, stride)
        # every window fits: the shifted signal carries seg zeros at its end
        windows.append(F.pad(mix, (soff, seg)).unfold(-1, seg, stride)[:, :, : len(offs)].transpose(1, 2))
        metas += [o - soff for o in offs]
    batch = torch.cat(windows, dim=1).reshape(-1, 2, seg)  # [B·W, 2, seg], song-major
    stems = torch.cat([model(batch[i : i + _FWD_CHUNK], bf16=bf16) for i in range(0, batch.shape[0], _FWD_CHUNK)])

    # triangular-weighted overlap-add of every window of a song in one index_add_
    n_sources = stems.shape[1]
    stems = stems.reshape(n_songs, len(metas), n_sources, 2, seg)
    tri = _triangle(seg, y.device)
    lead = max(0, -min(metas))
    pos = torch.tensor(metas, device=y.device) + lead
    idx = (pos[:, None] + torch.arange(seg, device=y.device)).reshape(-1)
    src = (stems * tri).permute(0, 2, 3, 1, 4).reshape(n_songs, n_sources, 2, -1)
    acc = stems.new_zeros(n_songs, n_sources, 2, lead + L44 + seg).index_add_(-1, idx, src)
    wacc = tri.new_zeros(lead + L44 + seg).index_add_(0, idx, tri.repeat(len(metas)))
    out44 = acc[..., lead : lead + L44] / torch.clamp(wacc[lead : lead + L44], min=1e-8)
    mono = out44.mean(dim=2)  # [B, S, L44]
    mono = mono if sr == MODEL_SR else _down2(mono)
    return mono[0] if single else mono


# ------------------------------------------------------------- weights ------


@lru_cache(maxsize=4)
def _load_npz(path: str) -> dict | None:
    params = load_pytree_npz(path)
    return params if isinstance(params, dict) and "encoder" in params else None


def load_params(path: str | None = None) -> dict | None:
    """The checkpoint pytree, or None when ``HTDEMUCS_WEIGHTS`` is off or the
    file is missing. Cached by path: the same dict for every call."""
    path = weights_path("HTDEMUCS_WEIGHTS", "htdemucs.npz") if path is None else path
    if not path or not os.path.exists(path):
        return None
    return _load_npz(path)


@lru_cache(maxsize=4)
def _model(path: str, device: torch.device) -> HTDemucs:
    return HTDemucs.from_params(_load_npz(path)).to(device)


def load_model(device: torch.device) -> HTDemucs | None:
    """The checkpoint's module on ``device``, built and uploaded once per process and device."""
    path = weights_path("HTDEMUCS_WEIGHTS", "htdemucs.npz")
    if load_params(path) is None:
        return None
    return _model(path, device)


def program_config(params: dict, model_name: str, stem_priority: list[str]) -> dict:
    """Segment length, stride, source count, stem names and the stem/drums
    indices of a checkpoint for a stem priority list."""
    seg = int(np.asarray(params["meta_segment"])) if "meta_segment" in params else int(SEGMENT_SEC * MODEL_SR)
    seg = ((seg + ALIGN - 1) // ALIGN) * ALIGN
    stride = max(ALIGN, int((1 - OVERLAP) * seg) // ALIGN * ALIGN)
    n_sources = np.asarray(params["tdecoder"][-1]["convtr_w"]).shape[1] // 2
    names = MODEL_STEMS.get(model_name, MODEL_STEMS["htdemucs"])[:n_sources]
    stem_idx = next((names.index(n) for n in stem_priority if n in names), 2)
    drums_idx = names.index("drums") if "drums" in names else 0
    return {"seg": seg, "stride": stride, "n_sources": n_sources, "names": names,
            "stem_idx": stem_idx, "drums_idx": drums_idx}


def separate_stems_device(y: torch.Tensor, sr: int, model_name: str = "htdemucs_6s", shifts: int = 2,
                          bf16: bool = False) -> dict[str, torch.Tensor] | None:
    """Mono y [L] on the device → {stem name: stem [L]} on the same device,
    or None when no weights are loaded. A 2-D ``y`` or a rate other than
    MODEL_SR and MODEL_SR / 2 takes ``separate_stems``, the host path, as in
    the JAX package (which ignores ``shifts`` there and takes 2)."""
    params = load_params()
    if params is None:
        return None
    if y.dim() != 1 or sr not in (MODEL_SR, MODEL_SR // 2):
        # the JAX routing: other shapes and rates take the host path
        host = separate_stems(y.detach().cpu().numpy(), sr, model_name=model_name, device=y.device)
        return None if host is None else {k: torch.from_numpy(v).to(y.device) for k, v in host.items()}
    cfg = program_config(params, model_name, list(MODEL_STEMS["htdemucs"]))
    with torch.inference_mode():
        out = separate_program(load_model(y.device), y, sr, cfg["seg"], cfg["stride"], shifts, bf16=bf16)
    return {name: out[i] for i, name in enumerate(cfg["names"])}


# ---------------------------------------------------------- the host path --


def apply_model(net: HTDemucs, mix: np.ndarray, sr: int, *, shifts: int = 2, overlap: float = OVERLAP,
                rng: np.random.Generator | None = None, segment: int | None = None) -> np.ndarray:
    """Separate a song [ch, L] (numpy) → [n_sources, ch, L] (numpy).

    The JAX ``apply_model``: for each shift (the first unshifted, the others
    offset by ``rng.integers(0, max_shift)``, numpy's generator as in the JAX
    package), every overlapped window goes through ``net`` on its device,
    ``_FWD_CHUNK`` at a time, and the host overlap-adds them with the
    triangular window. ``segment`` is the checkpoint's ``meta_segment``."""
    rng = rng or np.random.default_rng(0)
    ch, L = mix.shape
    seg = int(SEGMENT_SEC * sr) if segment is None else int(segment)
    seg = ((seg + ALIGN - 1) // ALIGN) * ALIGN
    stride = max(ALIGN, int((1 - overlap) * seg) // ALIGN * ALIGN)
    max_shift = int(0.5 * sr)
    device = next(net.parameters()).device

    out = np.zeros((net.n_sources, ch, L), dtype=np.float32)
    weight_total = np.zeros((L,), dtype=np.float32)
    tri = np.concatenate([np.linspace(0.1, 1.0, seg // 2), np.linspace(1.0, 0.1, seg - seg // 2)]).astype(np.float32)
    for shift_i in range(max(1, shifts)):
        offset = int(rng.integers(0, max_shift)) if shifts > 1 and shift_i > 0 else 0
        padded = np.pad(mix, ((0, 0), (offset, seg)))
        offsets = _segment_windows(L + offset, seg, stride)
        windows = torch.from_numpy(np.stack([padded[:, o : o + seg] for o in offsets]).astype(np.float32)).to(device)
        with torch.inference_mode():
            stems = torch.cat([net(windows[i : i + _FWD_CHUNK]) for i in range(0, len(offsets), _FWD_CHUNK)]).cpu().numpy()
        for o, st in zip(offsets, stems):
            a = o - offset
            lo, hi = max(0, a), min(L, a + seg)
            w_lo = lo - a
            out[:, :, lo:hi] += st[:, :, w_lo : w_lo + hi - lo] * tri[w_lo : w_lo + hi - lo]
            weight_total[lo:hi] += tri[w_lo : w_lo + hi - lo]
    out /= np.maximum(weight_total, 1e-8)
    return out


def separate_stems(y: np.ndarray, sr: int, model_name: str = "htdemucs_6s", *, device=None) -> dict[str, np.ndarray] | None:
    """The JAX ``separate_stems``: mono [L] (pseudo-stereo) or [ch, L] at any
    rate → {stem name: mono float32 numpy}, or None when no weights are loaded.

    The host resamples to MODEL_SR and back with ``resample_poly_host``;
    ``apply_model`` runs the net on ``device`` (the card unless the caller
    names the CPU). As in the JAX package each stem is cut to ``len(y)``, the
    channel count for a 2-D input."""
    from ..device import resolve_device
    from ..io.resample import resample_poly_host

    params = load_params()
    if params is None:
        return None
    net = load_model(resolve_device(device))
    stems = MODEL_STEMS.get(model_name, MODEL_STEMS["htdemucs"])
    mix = np.stack([y, y]) if y.ndim == 1 else y
    if sr != MODEL_SR:
        mix = np.stack([resample_poly_host(c, sr, MODEL_SR) for c in mix])
    seg = int(np.asarray(params["meta_segment"])) if "meta_segment" in params else None
    out = apply_model(net, mix.astype(np.float32), MODEL_SR, segment=seg)
    result = {}
    for i, name in enumerate(stems[: out.shape[0]]):
        mono = out[i].mean(axis=0)
        if sr != MODEL_SR:
            mono = resample_poly_host(mono, MODEL_SR, sr)
        result[name] = mono[: len(y)].astype(np.float32)
    return result
