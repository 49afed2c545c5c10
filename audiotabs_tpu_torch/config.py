"""The ``Settings`` fields the ported analysis path reads.

Names, defaults and environment variables are those of
``audiotabs_tpu/config.py``, so one ``.env`` configures both packages.
Separation is a later slice of the port: the analysis path here is the
JAX package's ``ENABLE_DEMUCS=False`` configuration, so that field and the
others this path does not read are not copied yet.
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
    CHORD_DETECTION_BACKEND: str = "deep"  # deep|template
    SWITCH_PENALTY: float = 2.5
    PAD_SECONDS_BUCKET: float = 30.0

    @classmethod
    def from_env(cls) -> "Settings":
        return cls(**{f.name: _env(f.name, f.default) for f in dataclasses.fields(cls)})
