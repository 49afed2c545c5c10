"""Monophonic melody: pYIN pitch track → note events.

Counterpart of audiotabs_tpu/decode/melody.py. The pYIN track and the frame
RMS run on the device (ops/pyin.py, ops/features.py); the segmentation into
notes (``notes_from_f0``) is host numpy, arithmetic unchanged: split on
voicing gaps and on pitch moves larger than half a semitone, take the median
pitch per run, drop sub-minimum runs.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import on_device
from ..ops.features import rms
from ..ops.pyin import pyin
from ..theory.events import NoteEvent


def notes_from_f0(
    f0: np.ndarray,
    voiced: np.ndarray,
    hop_s: float,
    *,
    amplitudes: np.ndarray | None = None,
    min_note_s: float = 0.06,
    split_semitones: float = 0.6,
) -> list[NoteEvent]:
    f0 = np.asarray(f0, dtype=np.float64)
    voiced = np.asarray(voiced, dtype=bool)
    T = len(f0)
    midi = 69.0 + 12.0 * np.log2(np.maximum(f0, 1e-6) / 440.0)

    events: list[NoteEvent] = []
    i = 0
    while i < T:
        if not voiced[i]:
            i += 1
            continue
        j = i + 1
        while j < T and voiced[j] and abs(midi[j] - np.median(midi[i:j])) <= split_semitones:
            j += 1
        dur = (j - i) * hop_s
        if dur >= min_note_s:
            pitch = int(round(float(np.median(midi[i:j]))))
            if 0 <= pitch <= 127:
                amp = 0.5
                if amplitudes is not None:
                    k = min(len(amplitudes) - 1, j - 1)
                    amp = float(np.clip(np.max(amplitudes[i : k + 1]), 0.0, 1.0))
                events.append(
                    NoteEvent(
                        start_time_s=i * hop_s,
                        end_time_s=j * hop_s,
                        pitch_midi=pitch,
                        velocity=int(np.clip(40 + 87 * amp, 1, 127)),
                        amplitude=amp,
                    )
                )
        i = j
    return events


@torch.inference_mode()
def transcribe_melody(
    y,
    sr: int,
    *,
    fmin: float = 65.40639132514966,
    fmax: float = 2093.004522404789,
    frame_length: int = 2048,
    hop: int = 256,
    min_note_s: float = 0.06,
    device=None,
) -> list[NoteEvent]:
    """pYIN melody transcription of a mono signal (the track on the device)."""
    yd = on_device(y, device)
    f0, voiced, _ = pyin(yd, sr, fmin=fmin, fmax=fmax, frame_length=frame_length, hop=hop)
    f0, voiced = f0.cpu().numpy(), voiced.cpu().numpy()
    amps = rms(yd, frame_length=frame_length, hop=hop).cpu().numpy()
    amps = amps / (amps.max() + 1e-9)
    n = min(len(f0), len(amps))
    return notes_from_f0(f0[:n], voiced[:n], hop / sr, amplitudes=amps[:n], min_note_s=min_note_s)
