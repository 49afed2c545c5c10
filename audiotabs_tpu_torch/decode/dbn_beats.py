"""DBN beat tracking: the madmom bar-pointer model.

Counterpart of audiotabs_tpu/decode/dbn_beats.py (``_tempo_grid``,
``_tempo_transition``, ``_dbn_forward``, ``dbn_beat_track``,
``beats_from_decoded``, ``estimate_tempo``, ``normalize_beat_times``). The state
space is (tempo, phase) stored as a padded [n_tempi, max_interval] score
matrix; each frame is a phase roll plus a max-plus tempo transition at
phase 0. The forward pass and the backtrack, lax.scans in JAX, are plain
loops over frames that stay on the tensor's device.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from ..device import on_device
from ..ops.spectral import as_device


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


def _dbn_forward(
    activations: torch.Tensor,
    fps: int = 100,
    min_bpm: float = 55.0,
    max_bpm: float = 215.0,
    transition_lambda: float = 100.0,
    observation_lambda: int = 16,
):
    """Viterbi over the bar-pointer model → (phases [T], intervals [T]) int64.

    Parity trap: every argmax here must return the FIRST maximum, as
    jnp.argmax does; torch.argmax does so on the CPU and on CUDA."""
    dev = activations.device
    intervals_np = _tempo_grid(min_bpm, max_bpm, fps)
    n_tempi = len(intervals_np)
    max_int = int(intervals_np.max())
    intervals = torch.from_numpy(intervals_np.astype(np.int64)).to(dev)
    log_trans = as_device(_tempo_transition(min_bpm, max_bpm, fps, transition_lambda), activations)

    act = torch.clamp(activations.to(torch.float32), 1e-6, 1.0 - 1e-6)
    T = act.shape[0]
    phase_idx = torch.arange(max_int, device=dev)[None, :]
    valid = phase_idx < intervals[:, None]  # [n_tempi, P]
    beat_win = phase_idx < torch.ceil(intervals[:, None] / observation_lambda).to(torch.int64)
    lo_beat = torch.log(act)  # [T]
    lo_off = torch.log((1.0 - act) / (observation_lambda - 1))
    neg_inf = torch.tensor(-1e30, dtype=torch.float32, device=dev)
    tempo_ar = torch.arange(n_tempi, device=dev)

    def obs(t: int) -> torch.Tensor:
        return torch.where(beat_win, lo_beat[t], lo_off[t])  # [n_tempi, P]

    score = torch.where(valid, torch.log(1.0 / valid.sum().to(torch.float32)), neg_inf) + obs(0)
    bp_tempi = []
    for t in range(1, T):
        # phase advance: new[i, p] = score[i, p-1]; p=0 takes the best tempo change
        cand = score[tempo_ar, intervals - 1][:, None] + log_trans  # [from, to]
        bp = torch.argmax(cand, dim=0)
        enter0 = cand.gather(0, bp[None])[0]
        shifted = torch.roll(score, 1, dims=1)
        shifted[:, 0] = enter0
        score = torch.where(valid, shifted + obs(t), neg_inf)
        bp_tempi.append(bp)

    # backtrack: the phase falls by 1 per earlier frame; at phase 0 the
    # previous state was (bp_tempo, L_prev - 1)
    # states are 1-element tensors: indexing with them stays on the device,
    # where a 0-d index would be read back to the host at every frame
    flat = torch.argmax(score).reshape(1)
    tempo, phase = flat // max_int, flat % max_int
    tempos, phases = [tempo], [phase]
    for bp in reversed(bp_tempi):
        at_zero = phase == 0
        prev_tempo = torch.where(at_zero, bp[tempo], tempo)
        phase = torch.where(at_zero, intervals[prev_tempo] - 1, phase - 1)
        tempo = prev_tempo
        tempos.append(tempo)
        phases.append(phase)
    tempos = torch.cat(tempos[::-1])
    return torch.cat(phases[::-1]), intervals[tempos]


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
