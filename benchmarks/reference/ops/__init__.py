"""DSP on the device: STFT, CQT, HPSS, chroma, features, onsets, pYIN."""
