"""Sequential decoders: Viterbi, DBN beats (counterpart of audiotabs_tpu/decode/)."""

from .dbn_beats import dbn_beat_track, estimate_beats, estimate_tempo, normalize_beat_times
from .viterbi import viterbi_constant_switch, viterbi_log_dense

__all__ = [
    "viterbi_constant_switch",
    "viterbi_log_dense",
    "dbn_beat_track",
    "estimate_beats",
    "normalize_beat_times",
    "estimate_tempo",
]
