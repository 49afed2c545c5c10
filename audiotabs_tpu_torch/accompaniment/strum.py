"""Strum onset detection + beat-grid quantisation.

Counterpart of audiotabs_tpu/accompaniment/strum.py. The 22.05 kHz envelope
of the fused analysis (``_onset_strength_median``) runs on the device. The
native-rate envelope is defined by its host numpy form
(``_onset_strength_median_host``); on a CUDA device ``strum_flux_batch``
computes it for every strum segment of a song in one pass, and the detector
keeps that device flux only where each comparison that decides its onsets
clears ``GUARD_DB`` (else the segment's host envelope decides). The rest is
host numpy and scipy, arithmetic unchanged: librosa's peak picking
(``_peak_pick_np``), the strength gate, min-interval dedup and the
quantisation to the best beat subdivision (``quantize_onsets``).
"""

from __future__ import annotations

from functools import lru_cache
from typing import Iterable, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from ..device import resolve_device
from ..ops.features import mel_filterbank
from ..ops.spectral import as_device, stft
from ..theory.quantize import to_beats
from ..tracing import count, span, traced, uploaded
from ..train.optim import no_tf32

# The smallest margin, in dB of the unnormalised flux, that every comparison
# deciding a segment's onsets must clear on the device flux; divided by the
# segment's largest flux for the normalised envelope. The device flux differs
# from the host's by rounding alone (the FFT, the mel sum, log10); this is
# over 100 times the largest gap measured on an H100 (PERF.md).
GUARD_DB = 1e-2
# The device pass's FFT runs in blocks of this many frame rows (the frame
# count rounded up to it): one cuFFT plan whatever a song's length, made at
# its first song. Each batch size first met costs a plan, and some sizes a
# pageable host-to-device copy inside cuFFT (PERF.md).
_ROWS = 512


def _onset_strength_median(y: torch.Tensor, sr: int, hop: int = 512, n_fft: int = 2048) -> torch.Tensor:
    """librosa-faithful onset strength, median-aggregated over mel bands:
    Slaney mel power → dB floored at max−80 → positive first difference →
    median over bands → shifted by 1 + n_fft//(2·hop) frames. Centre padding
    is "constant", librosa 0.10's melspectrogram default."""
    S = torch.abs(stft(y, n_fft=n_fft, hop=hop, pad_mode="constant")) ** 2
    M = as_device(mel_filterbank(sr, n_fft, 128, scale="slaney"), y) @ S
    db = 10.0 * torch.log10(torch.clamp(M, min=1e-10))
    db = torch.maximum(db, db.amax(dim=(-2, -1), keepdim=True) - 80.0)
    diff = torch.clamp(db[..., :, 1:] - db[..., :, :-1], min=0.0)
    # parity trap: 128 bands is an even count; jnp.median averages the two
    # middle values there, torch.median would return the lower one
    flux = torch.quantile(diff, 0.5, dim=-2)
    shift = 1 + n_fft // (2 * hop)  # +1 for the diff, + the window-centre lag
    return F.pad(flux, (shift, 0))[..., : S.shape[-1]]


def _onset_strength_median_host(y: np.ndarray, sr: int, hop: int = 512, n_fft: int = 2048) -> np.ndarray:
    """Host-side numpy mirror of _onset_strength_median for the strum
    detector, which analyses the NATIVE-rate (44.1 kHz) audio — content
    above the 22.05 kHz analysis band carries the pick transients this
    envelope needs. The same definition as the device version above; on a
    CUDA device ``strum_flux_batch`` computes it for a song's segments, and
    this host form is what that pass is held to and falls back on.

    The arithmetic chain follows librosa 0.10.2 bit-for-bit (the pinned
    reference version): zero ("constant") center padding, float32 frames ×
    float64 Hann window → float64 product, rfft cast to complex64, |.|² in
    float32, float32 mel dot, float32 power_to_db with a whole-array
    top-80 dB floor, positive lag-1 diff, median over the 128 bands, and a
    left pad of lag + n_fft//(2·hop) frames."""
    n = len(y)
    if n < n_fft:
        y = np.pad(y, (0, n_fft - n))
    pad = n_fft // 2
    yp = np.pad(y.astype(np.float32), (pad, pad))  # librosa 0.10.x: constant
    n_frames = 1 + (len(yp) - n_fft) // hop
    idx = np.arange(n_fft)[None, :] + hop * np.arange(n_frames)[:, None]
    w = np.hanning(n_fft + 1)[:-1]  # float64, as librosa leaves get_window
    frames = yp[idx] * w  # float32 × float64 → float64 (librosa's promotion)
    spec = np.fft.rfft(frames, axis=-1).T.astype(np.complex64)
    S = np.abs(spec) ** 2  # float32 [F, T]
    fb = mel_filterbank(sr, n_fft, 128, scale="slaney")  # float32
    M = fb @ S  # float32
    db = (10.0 * np.log10(np.maximum(M, np.float32(1e-10)))).astype(np.float32)
    db = np.maximum(db, db.max() - np.float32(80.0))
    diff = np.maximum(0.0, db[:, 1:] - db[:, :-1])
    flux = np.median(diff, axis=0)
    shift = 1 + n_fft // (2 * hop)
    flux = np.pad(flux, (shift, 0))[: S.shape[1]]
    return flux


@lru_cache(maxsize=8)
def _envelope_constants(sr: int, n_fft: int, device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """The host envelope's float64 Hann window and float32 Slaney mel bank
    [128, F], uploaded once per device (copies, never views of the cached
    host arrays)."""
    with torch.inference_mode(False):  # normal tensors, usable in and out of inference mode
        w = uploaded(torch.from_numpy(np.hanning(n_fft + 1)[:-1]).to(device, copy=True))
        fb = uploaded(torch.from_numpy(mel_filterbank(sr, n_fft, 128, scale="slaney")).to(device, copy=True))
    return w, fb


def _median128(diff: torch.Tensor) -> torch.Tensor:
    """np.median over the last axis of 128 bands: the mean of the two middle
    values, (a + b) / 2 in float32 (torch.quantile interpolates otherwise)."""
    v = diff.sort(dim=-1).values
    return (v[..., 63] + v[..., 64]) / 2


def strum_flux_batch(
    y: np.ndarray, sr: int, bounds: Sequence[tuple[int, int]], device, hop: int = 512, n_fft: int = 2048
) -> list[np.ndarray]:
    """``_onset_strength_median_host(y[a:b], sr)`` for every (a, b) of
    ``bounds``, in one pass on ``device``: the unnormalised median flux of
    each segment, float32, equal to the host's up to rounding.

    Each segment keeps the host's definition: its own zero centre padding
    and frame origin at ``a`` (not on the song's hop grid), zeros up to
    ``n_fft`` when shorter, float32 frames × the float64 window, a float64
    rfft cast to complex64, |.|² and the mel product in float32 (TF32 off),
    its own top-80 dB floor, lag-1 differences inside it, the median of 128
    bands and the left shift. The segments' frames are one ragged batch with a
    frame→segment index: one gather, the FFT in blocks of ``_ROWS`` rows,
    one matmul, one median. The
    covered audio and the frame table go up as one buffer (one upload, a
    ``song`` one); only the medians come back."""
    dev = resolve_device(device)
    half, shift = n_fft // 2, 1 + n_fft // (2 * hop)
    frames_per = [1 + max(b - a, n_fft) // hop for a, b in bounds]
    rows = -(-sum(frames_per) // _ROWS) * _ROWS
    base = min(a for a, _ in bounds)
    x = np.ascontiguousarray(y[base : max(b for _, b in bounds)], dtype=np.float32)
    # per frame row: its first sample, its segment's [a, b) and its segment;
    # the padding rows read nothing and form segment len(bounds)
    table = np.zeros((4, rows), np.int32)
    table[3] = len(bounds)
    r = 0
    for s, ((a, b), t) in enumerate(zip(bounds, frames_per)):
        table[0, r : r + t] = a - base - half + hop * np.arange(t)
        table[1:, r : r + t] = np.array([a - base, b - base, s])[:, None]
        r += t
    buf = np.concatenate([x.view(np.int32), table.reshape(-1)])  # int32 copies keep the float bits
    with span("mode/strum_envelope"):
        d = uploaded(torch.from_numpy(buf).to(dev, copy=True), "song")
        audio = d[: len(x)].view(torch.float32)
        start, lo, hi, seg = d[len(x) :].view(4, rows).long()
        idx = start[:, None] + torch.arange(n_fft, device=dev)
        inside = (idx >= lo[:, None]) & (idx < hi[:, None])
        frames = torch.where(inside, audio[idx.clamp(0, len(x) - 1)], 0.0)
        w, fb = _envelope_constants(sr, n_fft, dev)
        spec = torch.empty(rows, half + 1, dtype=torch.complex128, device=dev)
        for part, out in zip((frames.double() * w).split(_ROWS), spec.split(_ROWS)):
            torch.fft.rfft(part, dim=-1, out=out)
        S = spec.to(torch.complex64).abs() ** 2  # float32 [rows, F]
        with no_tf32():  # the host's float32 product, whatever the process set
            mel = S @ fb.T
        db = 10.0 * torch.log10(torch.clamp(mel, min=1e-10))  # [rows, 128]
        top = torch.full((len(bounds) + 1,), -torch.inf, device=dev).scatter_reduce(0, seg, db.amax(dim=1), "amax")
        db = torch.maximum(db, (top - 80.0)[seg, None])
        # lag-1 pairs of every adjacent row; those across a segment's edge are dropped below
        med = _median128(torch.clamp(db[1:] - db[:-1], min=0.0)).cpu().numpy()
    fluxes, r = [], 0
    for t in frames_per:
        fluxes.append(np.pad(med[r : r + t - 1], (shift, 0))[:t])
        r += t
    return fluxes


def card_fluxes(y: np.ndarray, sr: int, bounds: Sequence[tuple[int, int]], device) -> list[np.ndarray | None]:
    """``strum_flux_batch`` where ``device`` is a CUDA device (what the pass
    raises, it raises); on any other device None for every segment, which
    then computes its host envelope."""
    if not bounds or device is None or torch.device(device).type != "cuda":
        return [None] * len(bounds)
    return strum_flux_batch(y, sr, bounds, device)


def _beats_from_index(beats_idx: np.ndarray, beat_times: np.ndarray) -> np.ndarray:
    beats = np.sort(np.asarray(beat_times, dtype=np.float64))
    idx = np.arange(len(beats), dtype=np.float64)
    avg = float(np.mean(np.diff(beats))) if len(beats) > 1 else 0.5
    avg = avg if avg > 0 else 0.5
    res = np.interp(beats_idx, idx, beats)
    lo = beats_idx < 0
    res[lo] = beats[0] + beats_idx[lo] * avg
    hi = beats_idx > idx[-1]
    res[hi] = beats[-1] + (beats_idx[hi] - idx[-1]) * avg
    return res


def _choose_grid(positions: np.ndarray) -> float:
    if positions.size == 0:
        return 0.5
    best = None
    for grid, penalty in ((0.25, 1.1), (0.5, 1.0), (1.0, 1.05)):
        q = np.round(positions / grid) * grid
        cost = float(np.mean(np.abs(positions - q))) * penalty
        if best is None or cost < best[0]:
            best = (cost, grid)
    return best[1]


def quantize_onsets(
    onsets_s: np.ndarray,
    *,
    beat_times: np.ndarray | None,
    tempo_bpm: float | None,
) -> np.ndarray:
    if onsets_s.size == 0:
        return onsets_s
    if beat_times is not None and len(beat_times) > 1:
        pos = to_beats(onsets_s, beat_times)
        grid = _choose_grid(pos)
        return _beats_from_index(np.round(pos / grid) * grid, beat_times)
    tempo = float(tempo_bpm or 0.0)
    if tempo <= 0:
        return onsets_s
    sec_per_q = 60.0 / tempo
    pos = onsets_s / sec_per_q
    grid = _choose_grid(pos)
    return np.round(pos / grid) * grid * sec_per_q


def _pick_windows(sr: int, hop: int) -> tuple[tuple[int, int], tuple[int, int], int]:
    """librosa.util.peak_pick's windows at onset_detect's operating point
    (librosa 0.10.2; reference strum.py:118-123): pre_max/post_max = 0.03
    s/0 s (+1), pre_avg/post_avg = 0.1 s, wait = 0.03 s, as (size, origin)
    of the moving max, (size, origin) of the moving mean, and the wait."""
    pre_max = int(np.ceil(0.03 * sr // hop))
    post_max = int(np.ceil(0.00 * sr // hop + 1))
    pre_avg = int(np.ceil(0.10 * sr // hop))
    post_avg = int(np.ceil(0.10 * sr // hop + 1))
    wait = int(np.ceil(0.03 * sr // hop))
    max_origin = int(np.ceil(0.5 * (pre_max - post_max)))
    avg_origin = int(np.ceil(0.5 * (pre_avg - post_avg)))
    return (pre_max + post_max, max_origin), (pre_avg + post_avg, avg_origin), wait


def _peak_pick_np(env: np.ndarray, delta: float, sr: int, hop: int = 512) -> np.ndarray:
    """librosa.util.peak_pick at onset_detect's operating point, exactly
    (``_pick_windows``; host numpy — tiny arrays, a device round-trip would
    cost more than the compute). The moving max/mean use librosa's scipy
    filters verbatim — maximum_filter1d(mode="constant") and
    uniform_filter1d(mode="nearest") — whose EDGE semantics (edge-value
    replication in the mean) differ from a naive clipped-window mean for
    the first/last ~0.1 s; peaks there decide whether an intro strum
    survives."""
    import scipy.ndimage as ndi

    x = np.asarray(env, dtype=np.float32)
    T = len(x)
    if T == 0:
        return np.zeros(0, dtype=np.int64)
    (max_size, max_origin), (avg_size, avg_origin), wait = _pick_windows(sr, hop)
    mov_max = ndi.maximum_filter1d(x, max_size, mode="constant", origin=max_origin)
    mov_avg = ndi.uniform_filter1d(x, avg_size, mode="nearest", origin=avg_origin)
    detections = x * (x == mov_max) * (x >= mov_avg + delta)
    frames: list[int] = []
    last = -np.inf
    for i in np.nonzero(detections)[0]:
        if i > last + wait:
            frames.append(int(i))
            last = int(i)
    return np.asarray(frames, dtype=np.int64)


def _pick_margin(env: np.ndarray, delta: float, sr: int, hop: int = 512) -> float:
    """The smallest margin of the comparisons that decide ``_peak_pick_np``
    on ``env`` (a non-negative envelope, so a frame is a detection exactly
    when both tests pass): each frame's local-max test against the largest
    other value of its max window, and its threshold test against
    mov_avg + delta. A frame is decided by a failing test's margin (the
    larger, where both fail), or by the smaller where both pass. The wait
    rule then reads frame indices alone."""
    import scipy.ndimage as ndi

    x = np.asarray(env, dtype=np.float32)
    if len(x) == 0:
        return np.inf
    (max_size, max_origin), (avg_size, avg_origin), _ = _pick_windows(sr, hop)
    mov_max = ndi.maximum_filter1d(x, max_size, mode="constant", origin=max_origin)
    mov_avg = ndi.uniform_filter1d(x, avg_size, mode="nearest", origin=avg_origin)
    # the max window's offsets, read off the filter itself (zeros past the ends)
    probe = np.zeros(2 * max_size + 1, np.float32)
    probe[max_size] = 1.0
    offsets = max_size - np.flatnonzero(ndi.maximum_filter1d(probe, max_size, mode="constant", origin=max_origin))
    xp = np.pad(x.astype(np.float64), (max_size, max_size))
    other = np.full(len(x), -np.inf)
    for d in offsets[offsets != 0]:
        other = np.maximum(other, xp[max_size + d : max_size + d + len(x)])
    is_max, m_max = x == mov_max, np.abs(x - other)
    above = x >= mov_avg + delta
    m_thr = np.abs(x.astype(np.float64) - (mov_avg.astype(np.float64) + delta))
    m = np.where(
        is_max,
        np.where(above, np.minimum(m_max, m_thr), m_thr),
        np.where(above, m_max, np.maximum(m_max, m_thr)),
    )
    return float(m.min())


def _gate_margin(strengths: np.ndarray, thr: float, gated: bool) -> float:
    """The smallest margin of the strength gate's comparisons ``s >= thr``.
    Gated, ``thr`` is max(0.1, percentile 40) − 1e-6, and the percentile is
    the interpolation p = 0.4·(n − 1) between the ranks k = ⌊p⌋ and k + 1:
    every rank above k lies at or above it, so is kept whatever the
    rounding; rank k lies 1e-6 − frac·gap from ``thr``, which moves with
    frac times the rounding (its margin is divided by frac, and it is kept
    always where frac is 0); the choice between 0.1 and the percentile is a
    comparison too."""
    s = strengths.astype(np.float64)
    if not gated:
        return float(np.abs(s - thr).min())
    pct = float(np.percentile(strengths, 40))
    m = np.abs(s - thr)
    if pct > 0.1:
        k, rem = divmod(2 * (len(s) - 1), 5)  # p = 0.4·(n − 1) = k + rem/5, exactly
        order = np.argsort(s, kind="stable")
        m[order[k + 1 :]] = np.inf
        m[order[k]] = m[order[k]] / (rem / 5) if rem else np.inf
    return float(min(m.min(), abs(pct - 0.1)))


def _strum_times(
    env: np.ndarray, sr: int, hop: int, delta: float, min_interval_s: float, margins: bool = False
) -> tuple[list[float], float]:
    """Onset times (s) from the normalised envelope ``env``: peak picking,
    the strength gate and the min-interval dedup; with ``margins`` also the
    smallest margin (in ``env``'s units) of every comparison that decided
    them, else inf."""
    frames = _peak_pick_np(env, delta=delta, sr=sr, hop=hop)
    margin = _pick_margin(env, delta, sr, hop) if margins else np.inf
    if frames.size == 0:
        return [], margin

    strengths = env[np.clip(frames, 0, len(env) - 1)]
    # The reference's percentile-40 strength gate exists to prune spurious
    # peaks out of a DENSE detection (strum.py:127-131). When the envelope
    # is already sparse (< ~0.5 peaks/s) our max-normalized median-mel
    # strengths cluster in a narrow band and pct-40 becomes a knife-edge
    # that drops REAL strums on float ties (golden: the 4.87 s and 6.82 s
    # attacks sat exactly at the percentile). Apply it only at high peak
    # density; the absolute 0.1 floor always holds.
    duration_s = len(env) * hop / sr
    gated = len(frames) > 1.0 * max(duration_s, 1.0)
    if gated:
        thr = max(0.1, float(np.percentile(strengths, 40))) - 1e-6
    else:
        thr = 0.1
    if margins:
        margin = min(margin, _gate_margin(strengths, thr, gated))
    keep = strengths >= thr
    frames, strengths = frames[keep], strengths[keep]

    times = frames * hop / sr
    # min-interval dedup keeping the stronger onset
    filtered: list[float] = []
    last_t = last_s = None
    for t, s in zip(times, strengths):
        if last_t is None or t - last_t >= min_interval_s:
            filtered.append(float(t))
            last_t, last_s = float(t), float(s)
        else:
            if margins:
                margin = min(margin, abs(float(s) - (last_s or 0.0)))
            if s > (last_s or 0.0):
                filtered[-1] = float(t)
                last_t, last_s = float(t), float(s)
    return filtered, margin


def _normalize(e: np.ndarray) -> np.ndarray:
    # librosa.util.normalize: scale by the max (reference strum.py:116)
    return e / (np.abs(e).max() + 1e-9)


@traced("mode/strum")
def detect_strum_onsets(
    y: np.ndarray,
    sr: int,
    *,
    beat_times: Iterable[float] | None = None,
    tempo_bpm: float | None = None,
    min_interval_s: float = 0.12,
    onset_delta: float = 0.2,
    hop: int = 512,
    envelope: np.ndarray | None = None,
    flux: np.ndarray | None = None,
) -> np.ndarray:
    """Detect strum onsets. Pass ``envelope`` (the normalized median-flux
    envelope at `hop` for this span, e.g. a slice of the fused program's
    strum_envelope) to skip the envelope pass entirely, or ``flux`` (this
    span's unnormalised median flux from ``strum_flux_batch``) to decide on
    it. The device flux stands only where every deciding comparison clears
    GUARD_DB over the span's largest flux; else the span's host envelope
    decides (counted as ``strum_fallbacks`` of ``strum_segments``), so the
    onsets are the host path's either way."""
    y = np.asarray(y, dtype=np.float32)
    if y.size == 0:
        return np.asarray([], dtype=np.float32)

    n_env = len(y) // hop + 1
    decide = dict(sr=sr, hop=hop, delta=onset_delta, min_interval_s=min_interval_s)
    filtered = None
    if envelope is not None:
        filtered, _ = _strum_times(_normalize(np.asarray(envelope, dtype=np.float32)), **decide)
    elif flux is not None:
        f = np.asarray(flux, dtype=np.float32)[:n_env]
        top = float(np.abs(f).max())
        times, margin = _strum_times(_normalize(f), **decide, margins=True)
        fell_back = not margin >= (GUARD_DB / top if top > 0 else np.inf)
        count("strum_segments")
        count("strum_fallbacks", int(fell_back))  # counted at 0 too, so a window without one reads 0
        filtered = None if fell_back else times
    if filtered is None:
        filtered, _ = _strum_times(_normalize(_onset_strength_median_host(y, sr, hop)[:n_env]), **decide)
    if not filtered:
        return np.asarray([], dtype=np.float32)

    onsets = np.asarray(filtered, dtype=np.float32)
    bt = np.asarray(list(beat_times), dtype=np.float32) if beat_times is not None else None
    onsets = quantize_onsets(onsets, beat_times=bt, tempo_bpm=tempo_bpm)

    onsets = np.sort(onsets)
    unique: list[float] = []
    for t in onsets:
        if not unique or t - unique[-1] > 1e-3:
            unique.append(float(t))
    return np.asarray(unique, dtype=np.float32)
