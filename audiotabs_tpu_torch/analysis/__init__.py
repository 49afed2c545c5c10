"""Content classification and audio-quality calibration (counterpart of audiotabs_tpu/analysis/)."""

from .audio_quality import analyze_audio_characteristics, calibrate_thresholds
from .content_classifier import ContentSegment, ContentType, analyze_musical_content

__all__ = [
    "ContentSegment",
    "ContentType",
    "analyze_musical_content",
    "analyze_audio_characteristics",
    "calibrate_thresholds",
]
