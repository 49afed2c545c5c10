"""Chord recognition: templates, extraction, segments."""
