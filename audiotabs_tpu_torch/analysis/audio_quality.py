"""Automatic AMT threshold calibration (host numpy).

The calibration of audiotabs_tpu/analysis/audio_quality.py: ``_to_db``,
``_interp_clamped`` and ``calibrate_thresholds``, the piecewise-linear
onset/frame threshold calibration clamped to [0.25, 0.75] / [0.15, 0.55],
arithmetic unchanged. The characteristics it reads come from the fused
analysis' calibration statistics; the standalone analysis
(``analyze_audio_characteristics``) is not ported (ROADMAP.md, queue 1,
item 14).
"""

from __future__ import annotations

import numpy as np


def _to_db(value: float) -> float:
    return float(20.0 * np.log10(max(float(value), 1e-12)))


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
