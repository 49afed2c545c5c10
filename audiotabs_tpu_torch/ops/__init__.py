"""DSP on the device: STFT, CQT, HPSS, chroma, features, onsets, pYIN
(counterpart of audiotabs_tpu/ops/)."""

from .chroma import chroma_cqt, chroma_from_cqt
from .cqt import cqt, cqt_kernel_bank, hybrid_cqt
from .features import mel_filterbank, melspectrogram, rms, spectral_centroid, spectral_rolloff
from .hpss import harmonic, hpss, hpss_masks
from .onset import onset_detect_frames, onset_strength
from .pyin import pyin
from .spectral import frame, hann_window, istft, magnitude_db, power_to_db, stft

__all__ = [
    "frame",
    "hann_window",
    "stft",
    "istft",
    "magnitude_db",
    "power_to_db",
    "cqt_kernel_bank",
    "cqt",
    "hybrid_cqt",
    "chroma_from_cqt",
    "chroma_cqt",
    "hpss_masks",
    "hpss",
    "harmonic",
    "mel_filterbank",
    "melspectrogram",
    "rms",
    "spectral_centroid",
    "spectral_rolloff",
    "onset_strength",
    "onset_detect_frames",
    "pyin",
]
