"""Accompaniment mode: strum onsets and chord shapes."""
