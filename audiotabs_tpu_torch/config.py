"""The ``Settings`` fields the port reads: the song analysis, the host tail and serving.

Names, defaults and environment variables are those of
``audiotabs_tpu/config.py``, so one ``.env`` configures both packages. The
shipped configuration separates first (``ENABLE_DEMUCS=True``: htdemucs
stems, the guitar stem analysed, the drums stem tracked for beats);
``ENABLE_DEMUCS=False`` analyses the mix. Fields this path does not read are
not copied: the separation program takes its segment from the checkpoint's
``meta_segment`` and its overlap from ``models/htdemucs.py::OVERLAP``, so
``DEMUCS_SEGMENT_SEC`` and ``DEMUCS_OVERLAP`` are not read, as in the JAX
package. ``FUSED_SPLIT_FETCH`` and ``PROFILE_DIR`` are the JAX package's
device→host transfer and trace knobs: the port always copies the fused
outputs in one transfer, and its spans (the package's ``tracing.py``) reach a
trace whenever a ``torch.profiler`` records, with no setting.
The serving knobs (``FRONTEND_ORIGIN`` to ``BATCH_SONGS_PER_DEVICE``) are read
by ``runtime/{jobs,server,celery_integration,batch_runner}.py``, and
``MESH_SHAPE``/``MESH_AXES`` by ``parallel/mesh.py::default_mesh`` (empty:
every card on one ``"data"`` axis; ``"4,2"`` / ``"data,model"`` for a 2-D
mesh). The JAX package's ``JOB_WORKERS`` is not copied: no code reads it
there.

There is no module-global ``settings``: every entry point takes a
``Settings`` (``Settings.from_env()`` when none is given).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any


def _env(name: str, default: Any) -> Any:
    raw = os.environ.get(name)
    if raw is None:
        return default
    if isinstance(default, bool):
        return raw.strip().lower() in ("1", "true", "yes", "on")
    if isinstance(default, int):
        return int(raw)
    if isinstance(default, float):
        return float(raw)
    return raw


@dataclasses.dataclass
class Settings:
    ENABLE_DEMUCS: bool = True
    DEMUCS_MODEL: str = "htdemucs_6s"
    DEMUCS_SHIFTS: int = 1
    DEMUCS_BF16: bool = False
    TRANSCRIPTION_STEM_PRIORITY: str = "guitar,other,vocals"
    BASIC_PITCH_ONSET_THRESHOLD: float = 0.5
    BASIC_PITCH_FRAME_THRESHOLD: float = 0.3
    BASIC_PITCH_MIN_NOTE_MS: float = 127.70
    ENABLE_AUTO_THRESHOLD_CALIBRATION: bool = True
    # notes mode's post-processing (theory/postprocess.py)
    HARMONIC_DUPLICATE_WINDOW_MS: float = 100.0
    HARMONIC_TOLERANCE_CENTS: float = 50.0
    HARMONIC_EVEN_THRESHOLD: float = 0.7
    HARMONIC_ODD_THRESHOLD: float = 0.55
    TEMPORAL_CLUSTER_WINDOW_MS: float = 80.0
    TEMPORAL_CLUSTER_GAP_MS: float = 50.0
    DISSONANCE_CORRECTION_AGGRESSIVENESS: float = 0.5
    DISSONANCE_WINDOW_MS: float = 60.0
    VOICE_ASSIGN_WINDOW_MS: float = 60.0
    GUITAR_TUNING: str = "standard"
    CHORD_DETECTION_BACKEND: str = "deep"  # deep|template
    CHORD_VOCAB: str = "majmin7"  # majmin|majmin7|majmin7plus
    SWITCH_PENALTY: float = 2.5
    MIN_SEGMENT_SEC: float = 0.25
    TRANSCRIPTION_MODE: str = "guitar"  # guitar|notes|accompaniment
    CONTENT_ANALYSIS_WINDOW_SEC: float = 3.0
    CONTENT_ANALYSIS_HOP_SEC: float = 1.5
    PAD_SECONDS_BUCKET: float = 30.0
    DATA_DIR: str = "./data"
    FRONTEND_ORIGIN: str = "http://localhost:3000"
    MAX_UPLOAD_MB: int = 500
    CELERY_ENABLED: bool = False
    REDIS_URL: str = "redis://localhost:6379/0"
    BATCH_SONGS_PER_DEVICE: int = 4
    MESH_SHAPE: str = ""  # e.g. "8" or "4,2"; empty = every card, 1-D
    MESH_AXES: str = "data"  # axis names matching MESH_SHAPE

    @classmethod
    def from_env(cls) -> "Settings":
        return cls(**{f.name: _env(f.name, f.default) for f in dataclasses.fields(cls)})

    def stem_priority(self) -> list[str]:
        return [s.strip() for s in self.TRANSCRIPTION_STEM_PRIORITY.split(",") if s.strip()]
