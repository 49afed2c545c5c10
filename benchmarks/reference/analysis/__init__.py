"""Content classification and audio-quality calibration."""
