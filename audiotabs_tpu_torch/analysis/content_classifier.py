"""Content classification: melodic vs chordal vs hybrid sections.

Counterpart of audiotabs_tpu/analysis/content_classifier.py. The window
metrics (``_window_metrics``) run on the device with all windows as one
batch (the JAX package vmaps one window's program), the HPSS medians of the
whole [W, 513, T] batch on the median kernel; the rule-based scoring
(``classify_metrics``, ``analyze_musical_content``,
``_segments_from_metrics``) is host numpy, arithmetic unchanged. The
pipeline passes the fused analysis' metrics as ``precomputed`` under the
shipped 3 s / 1.5 s windows; any other window setting builds its windows on
the host and computes their metrics on ``device`` (the card unless the
caller names the CPU).
"""

from __future__ import annotations

import logging
from dataclasses import dataclass, field
from enum import Enum
from typing import Literal

import numpy as np
import torch
import torch.nn.functional as F

from ..device import on_device
from ..ops.hpss import hpss_masks
from ..ops.onset import onset_detect_frames, onset_strength
from ..ops.pyin import pyin
from ..ops.spectral import stft
from ..tracing import traced

_LOG = logging.getLogger(__name__)

PITCH_DISPERSION_MELODIC = 4.0
PITCH_DISPERSION_CHORDAL = 2.0
ONSET_DENSITY_CHORDAL = 6.0
ONSET_DENSITY_MELODIC = 3.0
PERIODICITY_CHORDAL = 0.4
HARMONIC_RATIO_MELODIC = 0.6


class ContentType(str, Enum):
    MELODIC = "melodic"
    CHORDAL = "chordal"
    HYBRID = "hybrid"


@dataclass(frozen=True)
class ContentSegment:
    start_time_s: float
    end_time_s: float
    content_type: Literal["melodic", "chordal", "hybrid"]
    confidence: float
    metrics: dict = field(default_factory=dict)


def _window_metrics(windows: torch.Tensor, sr: int):
    """[W, N] batch of windows → (dispersion, onset_density, periodicity, harmonic_ratio), each [W]."""
    hop = 512
    n = windows.shape[-1]
    dur = n / sr

    # onset envelope + density
    env = onset_strength(windows, sr, hop=hop, n_fft=1024)  # [W, T]
    onsets = onset_detect_frames(env, delta=0.5, wait=4)
    onset_density = onsets.sum(dim=-1).to(torch.float32) / dur

    # periodicity: onset autocorrelation peak in the 60-200 BPM lag band
    e = env - env.mean(dim=-1, keepdim=True)
    norm = torch.linalg.vector_norm(e, dim=-1, keepdim=True)
    e = e / torch.clamp(norm, min=1e-6)
    T = e.shape[-1]
    lagged = F.pad(e, (0, T)).unfold(-1, T, 1)[..., :T, :]  # [W, lag, T]: e[t + lag]
    ac = (lagged * e[..., None, :]).sum(dim=-1)  # [W, lag]
    min_lag = max(1, int(sr * 60 / (200 * hop)))
    max_lag = max(min_lag + 1, int(sr * 60 / (60 * hop)))
    periodicity = torch.clamp(ac[..., min_lag:max_lag].max(dim=-1).values, 0.0, 1.0)
    periodicity = torch.where(norm[..., 0] < 1e-6, torch.zeros_like(periodicity), periodicity)

    # pitch dispersion (std of voiced midi pitches), E2..E6
    f0, voiced, _ = pyin(windows, sr, fmin=82.40688922821748, fmax=1318.5102276514797, frame_length=2048, hop=512)
    midi = 69.0 + 12.0 * torch.log2(torch.clamp(f0, min=1e-6) / 440.0)
    w = voiced.to(torch.float32)
    cnt = w.sum(dim=-1)
    mean = (midi * w).sum(dim=-1) / torch.clamp(cnt, min=1.0)
    var = (w * (midi - mean[..., None]) ** 2).sum(dim=-1) / torch.clamp(cnt, min=1.0)
    dispersion = torch.where(cnt >= 2, torch.sqrt(var), torch.zeros_like(var))

    # harmonic ratio via HPSS masks in the spectral domain; the whole
    # [W, F, T] batch is one median launch per direction (the JAX package
    # runs its XLA median here, use_pallas=False, as its Pallas path is 2-D only)
    S = torch.abs(stft(windows, n_fft=1024, hop=hop))
    mh, mp = hpss_masks(S, 17, 17)
    eh = ((S * mh) ** 2).sum(dim=(-2, -1))
    ep = ((S * mp) ** 2).sum(dim=(-2, -1))
    ratio = torch.where(eh + ep > 1e-9, eh / (eh + ep), torch.full_like(eh, 0.5))
    return dispersion, onset_density, periodicity, ratio


def classify_metrics(
    pitch_dispersion: float, onset_density: float, periodicity: float, harmonic_ratio: float
) -> tuple[ContentType, float]:
    """Rule-based scoring (reference: content_classifier.py:136-193)."""
    melodic = chordal = 0.0
    if pitch_dispersion >= PITCH_DISPERSION_MELODIC:
        melodic += 2.0
    elif pitch_dispersion <= PITCH_DISPERSION_CHORDAL:
        chordal += 2.0
    else:
        melodic += 0.5
        chordal += 0.5
    if onset_density >= ONSET_DENSITY_CHORDAL:
        chordal += 1.5
    elif onset_density <= ONSET_DENSITY_MELODIC:
        melodic += 1.0
    else:
        melodic += 0.5
        chordal += 0.5
    if periodicity >= PERIODICITY_CHORDAL:
        chordal += 1.5
    else:
        melodic += 0.5
    if harmonic_ratio >= HARMONIC_RATIO_MELODIC:
        melodic += 1.0
    else:
        chordal += 0.5

    total = melodic + chordal
    if total < 1e-6:
        return ContentType.HYBRID, 0.5
    confidence = min(1.0, abs(melodic - chordal) / total + 0.3)
    if melodic > chordal * 1.3:
        return ContentType.MELODIC, confidence
    if chordal > melodic * 1.3:
        return ContentType.CHORDAL, confidence
    return ContentType.HYBRID, max(0.3, confidence - 0.2)


@traced("mode/content")
def analyze_musical_content(
    y: np.ndarray,
    sr: int,
    *,
    window_sec: float = 3.0,
    hop_sec: float = 1.5,
    min_segment_sec: float = 1.0,
    precomputed: tuple[np.ndarray, np.ndarray] | None = None,
    device=None,
) -> list[ContentSegment]:
    """Classify sections. ``precomputed`` = (window start samples, [W, 4]
    metric matrix) from the fused analysis skips the device pass."""
    y = np.asarray(y)
    duration = len(y) / sr

    if precomputed is not None:
        starts_s, metrics = precomputed
        spans = [(int(p) / sr, min((int(p) + int(window_sec * sr)), len(y)) / sr) for p in starts_s]
        disp, dens, per, harm = (np.asarray(metrics)[:, i] for i in range(4))
        return _segments_from_metrics(spans, disp, dens, per, harm, min_segment_sec)

    y = np.asarray(y, dtype=np.float32)
    win = int(window_sec * sr)
    hop = int(hop_sec * sr)
    if duration < min_segment_sec or len(y) < win:
        pad = np.zeros(max(win, int(sr)), dtype=np.float32)
        pad[: len(y)] = y
        d, od, p, h = (float(v) for v in _metrics_on_device(pad[None, :], sr, device)[0])
        ctype, conf = classify_metrics(d, od, p, h)
        return [
            ContentSegment(0.0, duration, ctype.value, conf, {
                "pitch_dispersion": d, "onset_density": od, "periodicity": p, "harmonic_ratio": h,
            })
        ]

    starts = list(range(0, len(y) - int(0.5 * sr), hop))
    windows = np.zeros((len(starts), win), dtype=np.float32)
    spans = []
    for i, pos in enumerate(starts):
        end = min(pos + win, len(y))
        windows[i, : end - pos] = y[pos:end]
        spans.append((pos / sr, end / sr))

    disp, dens, per, harm = _metrics_on_device(windows, sr, device).T
    return _segments_from_metrics(spans, disp, dens, per, harm, min_segment_sec)


@torch.inference_mode()
def _metrics_on_device(windows: np.ndarray, sr: int, device) -> np.ndarray:
    """Host windows [W, N] → their metrics [W, 4] (host numpy), computed on ``device``."""
    return torch.stack(_window_metrics(on_device(windows, device), sr), dim=1).cpu().numpy()


def _segments_from_metrics(
    spans, disp, dens, per, harm, min_segment_sec: float
) -> list[ContentSegment]:
    raw = []
    for i, (t0, t1) in enumerate(spans):
        ctype, conf = classify_metrics(float(disp[i]), float(dens[i]), float(per[i]), float(harm[i]))
        raw.append((t0, t1, ctype, conf, {
            "pitch_dispersion": float(disp[i]), "onset_density": float(dens[i]),
            "periodicity": float(per[i]), "harmonic_ratio": float(harm[i]),
        }))

    if not raw:
        return [ContentSegment(0.0, 0.0, ContentType.HYBRID.value, 0.5, {})]

    # merge consecutive same-type windows
    merged: list[ContentSegment] = []
    cs, ce, ct, conf_sum, mlist, cnt = raw[0][0], raw[0][1], raw[0][2], raw[0][3], [raw[0][4]], 1
    for t0, t1, ctype, conf, m in raw[1:]:
        if ctype == ct:
            ce, conf_sum, cnt = t1, conf_sum + conf, cnt + 1
            mlist.append(m)
        else:
            avg = {k: float(np.mean([mm[k] for mm in mlist])) for k in mlist[0]}
            merged.append(ContentSegment(cs, ce, ct.value, conf_sum / cnt, avg))
            cs, ce, ct, conf_sum, mlist, cnt = t0, t1, ctype, conf, [m], 1
    avg = {k: float(np.mean([mm[k] for mm in mlist])) for k in mlist[0]}
    merged.append(ContentSegment(cs, ce, ct.value, conf_sum / cnt, avg))

    # absorb short segments into the longer neighbor
    final: list[ContentSegment] = []
    for seg in merged:
        if seg.end_time_s - seg.start_time_s < min_segment_sec and final:
            prev = final[-1]
            keep = (
                prev.content_type
                if prev.end_time_s - prev.start_time_s >= seg.end_time_s - seg.start_time_s
                else seg.content_type
            )
            final[-1] = ContentSegment(
                prev.start_time_s, seg.end_time_s, keep,
                (prev.confidence + seg.confidence) / 2, prev.metrics,
            )
        else:
            final.append(seg)

    _LOG.info(
        "content analysis: %d segments (melodic=%d chordal=%d hybrid=%d)",
        len(final),
        sum(1 for s in final if s.content_type == "melodic"),
        sum(1 for s in final if s.content_type == "chordal"),
        sum(1 for s in final if s.content_type == "hybrid"),
    )
    return final
