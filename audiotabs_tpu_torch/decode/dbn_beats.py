"""DBN beat tracking: the madmom bar-pointer model.

Counterpart of audiotabs_tpu/decode/dbn_beats.py (``_tempo_grid``,
``_tempo_transition``, ``_dbn_forward``, ``dbn_beat_track``,
``beats_from_decoded``, ``estimate_tempo``, ``normalize_beat_times``). The state
space is (tempo, phase) stored as a padded [n_tempi, max_interval] score
matrix; each frame is a phase roll plus a max-plus tempo transition at
phase 0. The forward pass and the backtrack, lax.scans in JAX, are one
launch of the CUDA kernel csrc/dbn_viterbi.cu for a batch of songs on the
card, at any tempo grid the JAX scan takes, and a plain loop over frames on
the CPU (``_dbn_forward_plain``).
torch computes every logarithm the kernel starts from (``_forward_inputs``),
so the kernel and the loop agree bit for bit.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache
from typing import NamedTuple

import numpy as np
import torch

from .. import _build
from ..device import on_device
from ..tracing import uploaded


@lru_cache(maxsize=8)
def _tempo_grid(min_bpm: float, max_bpm: float, fps: int) -> np.ndarray:
    min_int = int(np.floor(60.0 * fps / max_bpm))
    max_int = int(np.ceil(60.0 * fps / min_bpm))
    return np.arange(min_int, max_int + 1, dtype=np.int32)  # beat intervals in frames


@lru_cache(maxsize=8)
def _tempo_transition(min_bpm: float, max_bpm: float, fps: int, transition_lambda: float) -> np.ndarray:
    """Log tempo-transition matrix [from, to]; parity trap: built in f64, cast to f32."""
    intervals = _tempo_grid(min_bpm, max_bpm, fps).astype(np.float64)
    ratio = intervals[None, :] / intervals[:, None]
    p = np.exp(-transition_lambda * np.abs(np.log(ratio)))
    p /= p.sum(axis=1, keepdims=True)
    return np.log(p).astype(np.float32)


class _Grid(NamedTuple):
    """The tempo grid's tensors on one device: what every call starts from."""

    intervals: torch.Tensor  # [n_tempi] int64, beat intervals in frames
    log_trans: torch.Tensor  # [from, to] float32
    valid: torch.Tensor  # [n_tempi, P]: phase < interval
    beat_win: torch.Tensor  # [n_tempi, P]: the beat window, phase < ceil(interval / observation_lambda)
    init_prior: torch.Tensor  # [n_tempi, P] float32: log(1 / valid states) where valid, else -1e30
    intervals32: torch.Tensor  # [n_tempi] int32, for the kernel
    beat_len32: torch.Tensor  # [n_tempi] int32, for the kernel


@lru_cache(maxsize=8)
def _device_grid(min_bpm: float, max_bpm: float, fps: int, transition_lambda: float, observation_lambda: int,
                 device: torch.device) -> _Grid:
    """The tempo grid's tensors, uploaded once per device (not per call):
    copies, never views of the ``lru_cache``d arrays, and normal tensors, usable
    in and out of inference mode. Callers read them and never write them."""
    with torch.inference_mode(False):
        intervals_np = _tempo_grid(min_bpm, max_bpm, fps)
        intervals = uploaded(torch.from_numpy(intervals_np.astype(np.int64)).to(device, copy=True))
        log_trans = uploaded(torch.from_numpy(_tempo_transition(min_bpm, max_bpm, fps, transition_lambda)).to(device, copy=True))
        phase_idx = torch.arange(int(intervals_np.max()), device=device)[None, :]
        valid = phase_idx < intervals[:, None]
        beat_len = torch.ceil(intervals[:, None] / observation_lambda).to(torch.int64)
        neg_inf = uploaded(torch.tensor(-1e30, dtype=torch.float32, device=device))
        init_prior = torch.where(valid, torch.log(1.0 / valid.sum().to(torch.float32)), neg_inf)
        return _Grid(intervals, log_trans, valid, phase_idx < beat_len, init_prior,
                     intervals.to(torch.int32), beat_len[:, 0].to(torch.int32))


class _Forward(NamedTuple):
    """What the forward pass starts from, computed with torch on the activation's device."""

    grid: _Grid
    lo_beat: torch.Tensor  # [B, T]: log activation
    lo_off: torch.Tensor  # [B, T]: log off-beat term
    init: torch.Tensor  # [B, n_tempi, P]: the score at frame 0


def _forward_inputs(act: torch.Tensor, fps, min_bpm, max_bpm, transition_lambda, observation_lambda) -> _Forward:
    grid = _device_grid(min_bpm, max_bpm, fps, transition_lambda, observation_lambda, act.device)
    a = torch.clamp(act.to(torch.float32), 1e-6, 1.0 - 1e-6)
    lo_beat = torch.log(a)  # [B, T]
    lo_off = torch.log((1.0 - a) / (observation_lambda - 1))
    obs0 = torch.where(grid.beat_win, lo_beat[:, 0, None, None], lo_off[:, 0, None, None])
    return _Forward(grid, lo_beat, lo_off, grid.init_prior + obs0)


def _dbn_forward_plain(act: torch.Tensor, fps, min_bpm, max_bpm, transition_lambda, observation_lambda):
    """The plain version: [B, T] → (phases, intervals) [B, T] int32, a loop over frames."""
    f = _forward_inputs(act, fps, min_bpm, max_bpm, transition_lambda, observation_lambda)
    g = f.grid
    n_tempi, max_int = g.valid.shape
    neg_inf = uploaded(torch.tensor(-1e30, dtype=torch.float32, device=act.device))
    tempo_ar = torch.arange(n_tempi, device=act.device)
    score = f.init
    bp_tempi = []
    for t in range(1, act.shape[1]):
        # phase advance: new[i, p] = score[i, p-1]; p=0 takes the best tempo change
        cand = score[:, tempo_ar, g.intervals - 1][:, :, None] + g.log_trans  # [B, from, to]
        bp = torch.argmax(cand, dim=1)
        enter0 = cand.gather(1, bp[:, None])[:, 0]
        shifted = torch.roll(score, 1, dims=2)
        shifted[:, :, 0] = enter0
        obs = torch.where(g.beat_win, f.lo_beat[:, t, None, None], f.lo_off[:, t, None, None])
        score = torch.where(g.valid, shifted + obs, neg_inf)
        bp_tempi.append(bp)

    # backtrack: the phase falls by 1 per earlier frame; at phase 0 the
    # previous state was (bp_tempo, L_prev - 1); the states stay on the device
    flat = torch.argmax(score.reshape(score.shape[0], -1), dim=-1)
    tempo, phase = flat // max_int, flat % max_int
    tempos, phases = [tempo], [phase]
    for bp in reversed(bp_tempi):
        at_zero = phase == 0
        prev_tempo = torch.where(at_zero, bp.gather(1, tempo[:, None])[:, 0], tempo)
        phase = torch.where(at_zero, g.intervals[prev_tempo] - 1, phase - 1)
        tempo = prev_tempo
        tempos.append(tempo)
        phases.append(phase)
    tempos = torch.stack(tempos[::-1], dim=1)
    return torch.stack(phases[::-1], dim=1).to(torch.int32), g.intervals[tempos].to(torch.int32)


_ARGTYPES = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
# the launcher's codes for arguments the kernel does not take
_REFUSED = {-1: "a batch, length, tempo count or phase count out of range",
            -2: "the per-tempo vectors (5 floats a tempo) do not fit one block's shared memory: more than about 11,500 tempi"}


def _launch_args(act: torch.Tensor, fps, min_bpm, max_bpm, transition_lambda, observation_lambda) -> tuple:
    """The kernel's arguments for activations [B, T] on the card: what torch
    computes for it (the tempo grid's tensors from the per-device cache), the
    scratch for each frame's last-phase scores and for the score itself (one
    float a valid state: the launcher keeps it in device memory where it
    does not fit a block's shared memory) and the two [B, T] outputs."""
    f = _forward_inputs(act, fps, min_bpm, max_bpm, transition_lambda, observation_lambda)
    (B, T), n_tempi = act.shape, f.grid.valid.shape[0]
    n_states = int(_tempo_grid(min_bpm, max_bpm, fps).sum())
    dev = act.device
    return (
        f.init.contiguous(), f.lo_beat.contiguous(), f.lo_off.contiguous(), f.grid.log_trans, f.grid.intervals32,
        f.grid.beat_len32,
        torch.empty((B, max(T - 1, 1), n_tempi), dtype=torch.float32, device=dev),
        torch.empty((B, n_states), dtype=torch.float32, device=dev),
        torch.empty((B, T), dtype=torch.int32, device=dev), torch.empty((B, T), dtype=torch.int32, device=dev),
    )


def _dbn_forward_cuda(act: torch.Tensor, fps, min_bpm, max_bpm, transition_lambda, observation_lambda):
    """[B, T] on the card → (phases, intervals) [B, T] int32: one launch of
    csrc/dbn_viterbi.cu, one block per song."""
    args = _launch_args(act, fps, min_bpm, max_bpm, transition_lambda, observation_lambda)
    (B, n_tempi, max_int), T, n_states = args[0].shape, act.shape[1], args[7].shape[1]
    _build.launch("dbn_viterbi", "dbn_viterbi_f32", _ARGTYPES, act.device, *args, B, T, n_tempi, max_int, n_states, refused=_REFUSED)
    return args[-2], args[-1]


def _dbn_forward(
    activations: torch.Tensor,
    fps: int = 100,
    min_bpm: float = 55.0,
    max_bpm: float = 215.0,
    transition_lambda: float = 100.0,
    observation_lambda: int = 16,
):
    """Viterbi over the bar-pointer model: activations [T] or [B, T] →
    (phases, intervals) int32 of the same shape.

    A CUDA tensor launches csrc/dbn_viterbi.cu (every song of the batch in
    one launch); a CPU tensor takes the plain loop. Any other device raises.
    Parity trap: every argmax returns the FIRST maximum, as jnp.argmax does."""
    if activations.ndim not in (1, 2):
        raise ValueError(f"_dbn_forward takes [T] or [B, T], got shape {tuple(activations.shape)}")
    act = activations.reshape(1, -1) if activations.ndim == 1 else activations
    phases, intervals = _build.plain_or_kernel("_dbn_forward", _dbn_forward_plain, _dbn_forward_cuda, act, fps, min_bpm, max_bpm,
                                               transition_lambda, observation_lambda)
    return (phases, intervals) if activations.ndim == 2 else (phases[0], intervals[0])


@torch.inference_mode()
def dbn_beat_track(
    activations,
    fps: int = 100,
    min_bpm: float = 55.0,
    max_bpm: float = 215.0,
    transition_lambda: float = 100.0,
    observation_lambda: int = 16,
    threshold: float = 0.05,
    *,
    device=None,
) -> np.ndarray:
    """Activation function [T] at ``fps`` → beat times in seconds: the
    Viterbi on the activation's device (a host array goes to ``device``, the
    card unless the caller names the CPU), the peak picking on the host."""
    act = on_device(activations, device)
    if act.numel() < 2:
        return np.asarray([], dtype=np.float32)
    phases, intervals = _dbn_forward(
        act, fps=fps, min_bpm=min_bpm, max_bpm=max_bpm,
        transition_lambda=transition_lambda, observation_lambda=observation_lambda,
    )
    return beats_from_decoded(
        phases.cpu().numpy(), intervals.cpu().numpy(), act.cpu().numpy(),
        fps=fps, observation_lambda=observation_lambda, threshold=threshold,
    )


def beats_from_decoded(
    phases: np.ndarray,
    intervals: np.ndarray,
    act: np.ndarray,
    *,
    fps: int = 100,
    observation_lambda: int = 16,
    threshold: float = 0.05,
) -> np.ndarray:
    """Decoded (phase, interval) path + activation → beat times in seconds (host numpy).

    Beat = the max-activation frame inside each decoded beat window; beats
    in leading/trailing activation below threshold·max are dropped."""
    T = min(len(act), len(phases))
    phases, intervals, act = phases[:T], intervals[:T], act[:T]
    in_window = phases < np.ceil(intervals / observation_lambda).astype(np.int64)
    frames = []
    t = 0
    while t < T:
        if in_window[t]:
            u = t
            while u + 1 < T and in_window[u + 1]:
                u += 1
            frames.append(t + int(np.argmax(act[t : u + 1])))
            t = u + 1
        else:
            t += 1
    frames = np.asarray(frames, dtype=np.int64)
    if threshold > 0 and frames.size:
        thr = threshold * float(act.max())
        above = np.nonzero(act >= thr)[0]
        frames = frames[(frames >= above[0]) & (frames <= above[-1] + 1)] if above.size else frames[:0]
    return (frames / float(fps)).astype(np.float32)


def estimate_tempo(beat_times: np.ndarray) -> float:
    """Tempo = 60 / mean beat interval (reference: grid/beats.py:36-43)."""
    bt = np.asarray(beat_times, dtype=np.float64)
    if bt.size < 2:
        return 0.0
    diffs = np.diff(bt)
    diffs = diffs[np.isfinite(diffs) & (diffs > 0)]
    if diffs.size == 0:
        return 0.0
    return float(60.0 / np.mean(diffs))


def normalize_beat_times(beat_times: np.ndarray | None) -> tuple[np.ndarray | None, float]:
    """Shift beats to start at t=0, returning (beats, offset)
    (reference: grid/beats.py:92-101)."""
    if beat_times is None:
        return None, 0.0
    bt = np.asarray(beat_times, dtype=np.float32)
    bt = bt[np.isfinite(bt)]
    if bt.size == 0:
        return None, 0.0
    bt = np.sort(bt)
    offset = float(bt[0])
    return (bt - offset).astype(np.float32), offset


def estimate_beats(
    y,
    sr: int,
    *,
    fps: int = 100,
    min_bpm: float = 55.0,
    max_bpm: float = 215.0,
    device=None,
) -> tuple[float, np.ndarray]:
    """Full beat tracking: the beat activation on the device (the BLSTM
    ensemble of the checkpoint, else the onset activation) → the DBN decode
    → (tempo_bpm, beat_times); (0.0, []) when no beat is found. ``y`` is a
    tensor on its device, or a host array sent to ``device`` (the card
    unless the caller names the CPU).

    Mirrors the reference's estimate_beats contract (grid/beats.py:61-89)."""
    from ..models.beat_rnn import beat_activation
    from ..runtime.fused import load_models

    yd = on_device(y, device)
    with torch.inference_mode():
        act = beat_activation(yd, sr, load_models(yd.device).beat, fps)
    beats = dbn_beat_track(act, fps=fps, min_bpm=min_bpm, max_bpm=max_bpm)
    if beats.size == 0:
        return 0.0, np.asarray([], dtype=np.float32)
    return estimate_tempo(beats), beats
