"""Audio characteristics + automatic AMT threshold calibration.

Counterpart of audiotabs_tpu/analysis/audio_quality.py: at most 60 s at
22.05 kHz of RMS dB, noise floor (p10), spectral centroid and rolloff,
harmonic ratio and onset density (``_characteristics_kernel``, on the
device, the HPSS medians of the [513, T] spectrogram on the median kernel);
an mtime-keyed JSON cache with a 24 h TTL under ``<cache_dir>/audio_analysis``
(the JAX key); and the piecewise-linear onset/frame threshold calibration
clamped to [0.25, 0.75] / [0.15, 0.55] (host, arithmetic unchanged). The
pipeline reads the fused analysis' calibration statistics instead when it
has them.
"""

from __future__ import annotations

import json
import logging
import time
from pathlib import Path

import numpy as np
import torch

from ..device import on_device
from ..ops.features import rms, spectral_centroid, spectral_rolloff
from ..ops.hpss import hpss_masks
from ..ops.onset import onset_detect_frames, onset_strength
from ..ops.spectral import stft

_LOG = logging.getLogger(__name__)

ANALYSIS_SR = 22050
ANALYSIS_MAX_SEC = 60.0
CACHE_TTL_SEC = 24 * 60 * 60


def _characteristics_kernel(y: torch.Tensor, sr: int):
    """y [T] on the device → (rms median, noise rms, centroid, rolloff,
    harmonic ratio, onset density), 0-d tensors."""
    r = rms(y, 2048, 512)
    # parity trap: jnp.percentile interpolates linearly, as torch.quantile does
    rms_median = torch.quantile(r, 0.5)
    noise_rms = torch.quantile(r, 0.1)
    centroid = spectral_centroid(y, sr, 2048, 512).mean()
    rolloff = spectral_rolloff(y, sr, 2048, 512).mean()

    S = torch.abs(stft(y, n_fft=1024, hop=512))
    mh, mp = hpss_masks(S, 17, 17)
    eh = torch.sum((S * mh) ** 2)
    ep = torch.sum((S * mp) ** 2)
    harm_ratio = torch.where(eh + ep > 1e-9, eh / (eh + ep), torch.full_like(eh, 0.5))

    env = onset_strength(y, sr, hop=512, n_fft=1024)
    onsets = onset_detect_frames(env, delta=0.5, wait=4)
    onset_density = onsets.sum().to(torch.float32) / (y.shape[-1] / sr)
    return rms_median, noise_rms, centroid, rolloff, harm_ratio, onset_density


def _to_db(value: float) -> float:
    return float(20.0 * np.log10(max(float(value), 1e-12)))


def _cache_key(audio_path: Path) -> str:
    return f"{audio_path.stem}_{hash(audio_path.stat().st_mtime)}.json"


def analyze_audio_characteristics(
    audio_path: Path | str,
    *,
    cache_dir: Path | None = None,
    audio: np.ndarray | None = None,
    audio_sr: int | None = None,
    device=None,
) -> dict[str, float]:
    """Audio characteristics for calibration. Pass ``audio``/``audio_sr`` to
    analyse an already-decoded signal instead of reading ``audio_path``; the
    statistics are computed on ``device`` (the card unless the caller names
    the CPU)."""
    audio_path = Path(audio_path)
    if cache_dir is not None and audio_path.exists():
        cache_file = cache_dir / "audio_analysis" / _cache_key(audio_path)
        if cache_file.exists() and time.time() - cache_file.stat().st_mtime <= CACHE_TTL_SEC:
            try:
                payload = json.loads(cache_file.read_text())
                if isinstance(payload, dict):
                    return {str(k): float(v) for k, v in payload.items()}
            except Exception:
                pass

    from ..io.resample import resample_poly_host
    from ..io.wav import load_wav

    if audio is not None:
        y, sr = np.asarray(audio, dtype=np.float32), int(audio_sr or ANALYSIS_SR)
    else:
        y, sr = load_wav(audio_path, mono=True)
    if y.size == 0:
        raise ValueError("Audio loaded empty for analysis")
    if sr != ANALYSIS_SR:
        y = resample_poly_host(y, sr, ANALYSIS_SR)
        sr = ANALYSIS_SR
    y = y[: int(ANALYSIS_MAX_SEC * sr)]

    with torch.inference_mode():
        stats = torch.stack(_characteristics_kernel(on_device(y, device), sr)).cpu().numpy()
    rms_median, noise_rms, centroid, rolloff, harm, dens = (float(v) for v in stats)
    characteristics = {
        "rms_db": _to_db(rms_median),
        "spectral_centroid": centroid,
        "spectral_rolloff": rolloff,
        "harmonic_ratio": harm,
        "onset_density": dens,
        "noise_floor_db": _to_db(noise_rms),
    }

    if cache_dir is not None:
        try:
            root = cache_dir / "audio_analysis"
            root.mkdir(parents=True, exist_ok=True)
            (root / _cache_key(audio_path)).write_text(json.dumps(characteristics, indent=2))
        except Exception as exc:
            _LOG.warning("failed to save audio analysis cache: %s", exc)
    return characteristics


def _interp_clamped(x: float, x0: float, x1: float, y0: float, y1: float) -> float:
    if x <= x0:
        return y0
    if x >= x1:
        return y1
    return y0 + (x - x0) / (x1 - x0) * (y1 - y0)


def calibrate_thresholds(characteristics: dict[str, float]) -> tuple[float, float]:
    """→ (onset_threshold, frame_threshold) for the AMT posteriors."""
    onset, frame = 0.5, 0.3
    rms_db = characteristics.get("rms_db", -20.0)
    onset += _interp_clamped(rms_db, -25.0, -12.0, -0.12, 0.10)
    frame += _interp_clamped(rms_db, -25.0, -12.0, -0.10, 0.08)
    harm = characteristics.get("harmonic_ratio", 0.55)
    onset += _interp_clamped(harm, 0.4, 0.7, 0.12, -0.08)
    frame += _interp_clamped(harm, 0.4, 0.7, 0.10, -0.06)
    dens = characteristics.get("onset_density", 5.0)
    onset += _interp_clamped(dens, 3.0, 8.0, -0.05, 0.08)
    noise = characteristics.get("noise_floor_db", -45.0)
    frame += _interp_clamped(noise, -50.0, -35.0, -0.08, 0.10)
    return max(0.25, min(0.75, onset)), max(0.15, min(0.55, frame))
