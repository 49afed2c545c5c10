"""Guitar tablature: fretboard, open chords, the tab optimizer."""
