"""Seeded generator of the committed held-out evaluation corpus.

Counterpart of audiotabs_tpu/train/make_heldout.py, in numpy: the same
``HELDOUT_VERSION``, compositions and seeds, rendered with the port's
``train/synth.py`` timbres, ``tab/`` voicings and ``io/wav.py::write_wav``,
so it writes the six clips under ``tests/data/heldout/`` and their exact
ground truth (beat grid, chord spans, note events, key) byte-identically to
the committed ``MANIFEST.md5``. No trainer draws these clips.

The corpus:

- ``fingerpick``       solo fingerpicking, E major, 96 BPM, 4/4
- ``picked_melody``    loud picked melody over a quiet chord bed, D major
- ``waltz_fingerpick`` triple meter (chords change every 3 beats), C major
- ``strum_band``       full band mix (drums/bass/vocals/piano/strummed
                       guitar), A major
- ``barre_band``       minor-key band mix with piano stabs, E minor, 126 BPM
- ``vocal_band``       vocal-dominated mix, G major

Band clips are built stem by stem in the htdemucs trainer's timbre palette
(``synth_multitrack``); their ground-truth notes are the guitar stem's.

Usage::

    python -m audiotabs_tpu_torch.train.make_heldout --check
    python -m audiotabs_tpu_torch.train.make_heldout --outdir DIR

``--check`` regenerates into a temporary directory and compares its bytes
with the committed manifest. Nothing is written to ``tests/data/heldout/``
unless ``--outdir`` names it.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import tempfile
from pathlib import Path

import numpy as np

from ..tab.fretboard import STANDARD_TUNING, positions_to_pitches
from ..tab.open_chords import OPEN_POSITION_CHORDS, shape_to_positions
from .synth import _noise_burst, _piano_note, _pluck

HELDOUT_DIR = Path(__file__).resolve().parents[2] / "tests" / "data" / "heldout"
MANIFEST = "MANIFEST.md5"

# the JAX generator's version: the committed manifest pins these bytes
HELDOUT_VERSION = 1

PC_NAMES = ["C", "C#", "D", "D#", "E", "F", "F#", "G", "G#", "A", "A#", "B"]


def _shape_pitches(label: str) -> list[int]:
    return positions_to_pitches(shape_to_positions(OPEN_POSITION_CHORDS[label]), STANDARD_TUNING)


# Barre voicings for chords with no open shape (frets strings 6→1, -1 muted).
_BARRE_SHAPES = {
    "B:maj": (-1, 2, 4, 4, 4, 2),
    "C#:min": (-1, 4, 6, 6, 5, 4),
    "B:min": (-1, 2, 4, 4, 3, 2),
    "F#:min": (2, 4, 4, 2, 2, 2),
    "F:maj": (1, 3, 3, 2, 1, 1),
}


def _voicing(label: str) -> list[int]:
    if label in OPEN_POSITION_CHORDS:
        return _shape_pitches(label)
    return positions_to_pitches(shape_to_positions(_BARRE_SHAPES[label]), STANDARD_TUNING)


def _label_parts(label: str) -> tuple[int, str]:
    root, _, quality = label.partition(":")
    return PC_NAMES.index(root), quality


class _Clip:
    """Accumulates rendered audio + exact ground truth for one clip."""

    def __init__(self, duration_s: float, sr: int, seed: int, stems: tuple[str, ...] = ("mix",)):
        self.sr = sr
        self.n = int(duration_s * sr)
        self.rng = np.random.default_rng(seed)
        self.stems = {s: np.zeros(self.n, dtype=np.float64) for s in stems}
        self.notes: list[dict] = []
        self.beats: list[float] = []
        self.chords: list[dict] = []

    def pluck(self, stem: str, t: float, dur: float, midi: int, amp: float,
              decay: float, *, label: bool = True) -> None:
        a = int(round(t * self.sr))
        d = min(int(dur * self.sr), self.n - a)
        if d <= 0 or a < 0:
            return
        seg = np.arange(d) / self.sr
        f = 440.0 * 2 ** ((midi - 69) / 12)
        self.stems[stem][a:a + d] += amp * _pluck(f, seg, self.rng, decay=decay)
        if label:
            self.notes.append({"start": round(t, 4), "end": round(t + d / self.sr, 4), "pitch": int(midi)})

    def piano(self, stem: str, t: float, dur: float, midi: int, amp: float, decay: float) -> None:
        a = int(round(t * self.sr))
        d = min(int(dur * self.sr), self.n - a)
        if d <= 0 or a < 0:
            return
        seg = np.arange(d) / self.sr
        f = 440.0 * 2 ** ((midi - 69) / 12)
        self.stems[stem][a:a + d] += amp * _piano_note(f, seg, self.rng, decay=decay)

    def chord_grid(self, progression: list[str], beats_per_chord: int, t0: float, period: float) -> list[tuple[str, list[float]]]:
        """Lay the beat grid + chord ground-truth spans; → per-chord beat lists."""
        spans = []
        t = t0
        for label in progression:
            chord_beats = [t + k * period for k in range(beats_per_chord)]
            self.beats.extend(chord_beats)
            root_pc, quality = _label_parts(label)
            spans.append((label, chord_beats))
            self.chords.append({
                "start": round(chord_beats[0], 4),
                "end": round(chord_beats[0] + beats_per_chord * period, 4),
                "root_pc": root_pc,
                "quality": quality,
            })
            t += beats_per_chord * period
        return spans


def _finish_mono(clip: _Clip, noise_amp: float = 0.002) -> np.ndarray:
    y = clip.stems["mix"]
    y = y + noise_amp * clip.rng.standard_normal(clip.n)
    peak = np.abs(y).max() + 1e-9
    return (0.9 * y / peak).astype(np.float32)


def _finish_stereo(clip: _Clip, order: tuple[str, ...], pans: dict[str, float],
                   levels: dict[str, float], noise_amp: float = 0.0015) -> np.ndarray:
    """Pan mono stems near-center (the htdemucs training layout) → [T, 2]."""
    mix = np.zeros((clip.n, 2), dtype=np.float64)
    for s in order:
        st = levels[s] * clip.stems[s]
        mix[:, 0] += pans[s] * st
        mix[:, 1] += (1.0 - pans[s]) * st
    mix += noise_amp * clip.rng.standard_normal((clip.n, 2))
    peak = np.abs(mix).max() + 1e-9
    return (0.9 * mix / peak).astype(np.float32)


# ---------------------------------------------------------------------------
# Clip 1: solo fingerpicking, E major, 96 BPM, 4/4.
# Alternating root/fifth bass ON the beat, chord-tone arpeggios on the
# off-eighths — the golden WAV's regime at a different key and tempo.
# ---------------------------------------------------------------------------

def make_fingerpick() -> tuple[np.ndarray, int, dict]:
    sr, tempo = 22050, 96.0
    period = 60.0 / tempo
    prog = ["E:maj", "A:maj", "B:maj", "E:maj", "C#:min", "A:maj", "B:maj", "E:maj"]
    clip = _Clip(duration_s=0.5 + 8 * 4 * period + 1.2, sr=sr, seed=71)
    spans = clip.chord_grid(prog, beats_per_chord=4, t0=0.5, period=period)

    roots = {"E:maj": 52, "A:maj": 57, "B:maj": 59, "C#:min": 49}
    triad = {"maj": (0, 4, 7), "min": (0, 3, 7)}
    for label, chord_beats in spans:
        root = roots[label]
        _, quality = _label_parts(label)
        ivs = triad[quality]
        for bi, b in enumerate(chord_beats):
            bass = root - 12 + (7 if bi % 2 == 1 else 0)
            clip.pluck("mix", b, 0.95 * period, bass, 0.36, decay=1.5 / period)
            # arpeggio: 3rd, 5th, root-octave on the off-eighths (deterministic)
            arp = [root + ivs[1], root + ivs[2], root + 12]
            for k, frac in enumerate((0.25, 0.5, 0.75)):
                if bi == 3 and k == 2:  # breathe before the chord change
                    continue
                clip.pluck("mix", b + frac * period, 0.4 * period, arp[k], 0.17, decay=2.5 / period)
    y = _finish_mono(clip)
    gt = {"band": False, "key": {"tonic_pc": 4, "mode": "major"},
          "beats": clip.beats, "chords": clip.chords, "notes": clip.notes}
    return y, sr, gt


# ---------------------------------------------------------------------------
# Clip 2: loud picked melody over a quiet sustained chord bed, D major,
# 88 BPM. The 3-5x amplitude imbalance is the regime the AMT must recall
# the bed through (bed 0.10 vs melody 0.45).
# ---------------------------------------------------------------------------

def make_picked_melody() -> tuple[np.ndarray, int, dict]:
    sr, tempo = 22050, 88.0
    period = 60.0 / tempo
    prog = ["D:maj", "G:maj", "A:maj", "D:maj", "B:min", "G:maj", "A:maj", "D:maj"]
    clip = _Clip(duration_s=0.5 + 8 * 4 * period + 1.2, sr=sr, seed=72)
    spans = clip.chord_grid(prog, beats_per_chord=4, t0=0.5, period=period)

    beds = {
        "D:maj": [50, 57, 62, 66],
        "G:maj": [43, 50, 55, 59],
        "A:maj": [45, 52, 57, 61],
        "B:min": [47, 54, 59, 62],
    }
    # melody: one diatonic phrase per chord, quarters with a pair of eighths
    # (degrees relative to D4=62 in the D-major scale). Phrases anchor D/F#
    # on strong beats — an A/C#-heavy melody over the near-silent bed read
    # as A major at introduction (the dominant-as-tonic failure).
    scale = [62, 64, 66, 67, 69, 71, 73, 74]
    phrases = {
        "D:maj": [0, 4, 2, 0], "G:maj": [3, 1, 5, 3], "A:maj": [4, 5, 4, 2], "B:min": [5, 2, 1, 0],
    }
    basses = {"D:maj": 50, "G:maj": 43, "A:maj": 45, "B:min": 47}
    for ci, (label, chord_beats) in enumerate(spans):
        for k, p in enumerate(beds[label]):
            clip.pluck("mix", chord_beats[0] + 0.006 * k, 4 * period * 0.92, p, 0.13, decay=0.35 / period)
        # mid-span bed re-pluck: the sustained bed decays below the chroma
        # N-gate by beat 3 of each span (A:maj spans read as N at 0.11 amp)
        for k, p in enumerate(beds[label]):
            clip.pluck("mix", chord_beats[2] + 0.006 * k, 2 * period * 0.9, p, 0.10, decay=0.5 / period)
        phrase = phrases[label]
        for bi, b in enumerate(chord_beats):
            # root bass on beats 1 and 3: the tonal anchor the key CNN was
            # trained to expect (synth_key_clip's bass-emphasis rationale) —
            # without it the loud melody's dominant reads as the tonic
            if bi % 2 == 0:
                clip.pluck("mix", b, 0.9 * period, basses[label], 0.34, decay=1.2 / period)
            deg = phrase[bi]
            clip.pluck("mix", b, 0.55 * period, scale[deg], 0.45, decay=1.8 / period)
            if bi == 2:  # eighth-note pickup into the next beat
                clip.pluck("mix", b + 0.5 * period, 0.35 * period, scale[(deg + 1) % 8], 0.38, decay=2.2 / period)
    y = _finish_mono(clip)
    gt = {"band": False, "key": {"tonic_pc": 2, "mode": "major"},
          "beats": clip.beats, "chords": clip.chords, "notes": clip.notes}
    return y, sr, gt


# ---------------------------------------------------------------------------
# Clip 3: triple-meter fingerpick, C major, 90 BPM — the only corpus clip
# outside duple meter (chords change every 3 beats).
# ---------------------------------------------------------------------------

def make_waltz_fingerpick() -> tuple[np.ndarray, int, dict]:
    sr, tempo = 22050, 90.0
    period = 60.0 / tempo
    # tonic-anchored progression: C every other chord, a single F — a
    # second F before the final C read as F major at introduction
    prog = ["C:maj", "F:maj", "G:maj", "C:maj", "A:min", "D:min", "G:maj", "C:maj", "G:maj", "C:maj"]
    clip = _Clip(duration_s=0.5 + len(prog) * 3 * period + 1.2, sr=sr, seed=73)
    spans = clip.chord_grid(prog, beats_per_chord=3, t0=0.5, period=period)

    voicings = {lbl: _voicing(lbl) for lbl in set(prog)}
    # small F (x-x-3-2-1-1): the full barre's F2 — the clip's lowest note,
    # sustained ~2 s per span — anchored the key CNN on F at introduction
    voicings["F:maj"] = positions_to_pitches(
        shape_to_positions((-1, -1, 3, 2, 1, 1)), STANDARD_TUNING
    )
    for label, chord_beats in spans:
        v = voicings[label]
        bass, uppers = v[0], v[-3:]
        # waltz pattern: bass on 1, two upper chord tones on 2 and 3
        clip.pluck("mix", chord_beats[0], 2.8 * period, bass, 0.38, decay=0.8 / period)
        for bi, b in enumerate(chord_beats[1:], start=1):
            clip.pluck("mix", b, 0.85 * period, uppers[bi - 1], 0.22, decay=1.8 / period)
            clip.pluck("mix", b + 0.004, 0.85 * period, uppers[bi], 0.18, decay=1.8 / period)
        # off-eighth passing tone between beats 2 and 3
        clip.pluck("mix", chord_beats[1] + 0.5 * period, 0.4 * period, uppers[2], 0.15, decay=2.5 / period)
    # melody over the top — the tonal cue synth_key_clip always provides;
    # without it the 29 k-param key CNN was diffuse on this clip (E min
    # 0.148 / F min 0.130 / C maj 0.071 at introduction). Melody notes are
    # CHORD TONES an octave up (a scale-tone melody put F5 over G:maj and
    # tipped the chroma net to G:min — overlap 0.995 → 0.900)
    chord_melody = {
        "C:maj": [72, 76, 79], "F:maj": [77, 81, 72], "G:maj": [79, 83, 74],
        "A:min": [81, 72, 76], "D:min": [74, 77, 81],
    }
    for label, chord_beats in spans:
        tones = chord_melody[label]
        for bi, b in enumerate(chord_beats):
            clip.pluck("mix", b, 0.8 * period, tones[bi], 0.18, decay=2.2 / period)
    y = _finish_mono(clip)
    gt = {"band": False, "key": {"tonic_pc": 0, "mode": "major"},
          "beats": clip.beats, "chords": clip.chords, "notes": clip.notes}
    return y, sr, gt


# ---------------------------------------------------------------------------
# Band-clip shared rendering: drums / bass / vocals / piano stems in the
# synth_multitrack timbre palette (fixed per-clip percussion samples).
# ---------------------------------------------------------------------------

def _band_drums(clip: _Clip, beats: list[float], period: float) -> None:
    sr, n = clip.sr, clip.n
    kick_dur = int(0.05 * sr)
    kseg = np.arange(kick_dur) / sr
    kick = 0.8 * np.sin(2 * np.pi * (140 * np.exp(-kseg * 30) + 45) * kseg) * np.exp(-kseg * 60)
    snare = 0.5 * _noise_burst(clip.rng, kick_dur, 5.0)
    hat_dur = int(0.02 * sr)
    hat = 0.25 * _noise_burst(clip.rng, hat_dur, 12.0)
    drums = clip.stems["drums"]
    for i, b in enumerate(beats):
        a = int(round(b * sr))
        if a + kick_dur < n:
            drums[a:a + kick_dur] += kick
            if i % 2 == 1:
                drums[a:a + kick_dur] += snare
        ha = int(round((b + period / 2) * sr))
        if ha + hat_dur < n:
            drums[ha:ha + hat_dur] += hat


def _band_vocals(clip: _Clip, phrases: list[tuple[float, float, int]]) -> None:
    """Vibrato melody phrases: (start, dur, midi)."""
    sr, n = clip.sr, clip.n
    vocals = clip.stems["vocals"]
    for t0, dur, p in phrases:
        a = int(round(t0 * sr))
        d = min(int(dur * sr), n - a)
        if d <= 0:
            continue
        seg = np.arange(d) / sr
        f0 = 440.0 * 2 ** ((p - 69) / 12)
        vib = f0 * (1.0 + 0.015 * np.sin(2 * np.pi * 5.5 * seg))
        phase = 2 * np.pi * np.cumsum(vib) / sr
        env = np.minimum(1, 8 * seg) * np.minimum(1, 8 * (seg[-1] - seg + 1e-3))
        vocals[a:a + d] += 0.5 * env * (np.sin(phase) + 0.4 * np.sin(2 * phase) + 0.15 * np.sin(3 * phase))


# ---------------------------------------------------------------------------
# Clip 4: full band mix, A major, 108 BPM — strummed guitar + drums + bass +
# vocals + piano. Drives stem routing and the separation A/B gate; GT notes
# are the guitar stem's strummed voicings only.
# ---------------------------------------------------------------------------

def make_strum_band() -> tuple[np.ndarray, int, dict]:
    sr, tempo = 44100, 108.0
    period = 60.0 / tempo
    prog = ["A:maj", "D:maj", "E:maj", "A:maj", "F#:min", "D:maj", "E:maj", "A:maj"]
    clip = _Clip(duration_s=0.5 + 8 * 4 * period + 1.0, sr=sr, seed=74,
                 stems=("drums", "bass", "vocals", "piano", "guitar"))
    spans = clip.chord_grid(prog, beats_per_chord=4, t0=0.5, period=period)
    beats = clip.beats

    _band_drums(clip, beats, period)

    voicings = {lbl: _voicing(lbl) for lbl in set(prog)}
    scale = [69, 71, 73, 74, 76, 78, 80, 81]  # A major from A4
    vocal_phrases = []
    for ci, (label, chord_beats) in enumerate(spans):
        v = voicings[label]
        root_pc, _ = _label_parts(label)
        bass_midi = 33 + ((root_pc - 9) % 12)  # bass register anchored at A1
        for bi, b in enumerate(chord_beats):
            # bass: root pluck every beat, fifth on beat 3
            bp = bass_midi + (7 if bi == 2 else 0)
            clip.pluck("bass", b, 0.9 * period, bp, 0.6, decay=2.0 / period, label=False)
            # guitar: down-strum on 1/3 (full voicing), lighter up-strum on 2/4
            up = bi % 2 == 1
            order = list(reversed(v))[:4] if up else list(v)
            amp = 0.16 if up else 0.24
            for k, p in enumerate(order):
                clip.pluck("guitar", b + 0.005 * k, 0.9 * period, p, amp, decay=1.5 / period)
            # piano: offbeat comping stab an octave up (beats 2 and 4)
            if bi % 2 == 1:
                for iv in (0, 4 if "maj" in label else 3, 7):
                    clip.piano("piano", b, 1.1 * period, 57 + ((root_pc - 9) % 12) + 12 + iv, 0.3, decay=1.2 / period)
        # one vocal phrase per chord: two sustained scale tones
        deg = [0, 2, 4, 0, 5, 2, 4, 0][ci]
        vocal_phrases.append((chord_beats[0] + 0.25 * period, 1.4 * period, scale[deg]))
        vocal_phrases.append((chord_beats[2] + 0.25 * period, 1.2 * period, scale[(deg + 2) % 8]))
    _band_vocals(clip, vocal_phrases)

    mix = _finish_stereo(
        clip, ("drums", "bass", "vocals", "piano", "guitar"),
        pans={"drums": 0.5, "bass": 0.48, "vocals": 0.55, "piano": 0.4, "guitar": 0.6},
        levels={"drums": 0.8, "bass": 0.7, "vocals": 0.6, "piano": 0.55, "guitar": 1.0},
    )
    gt = {"band": True, "key": {"tonic_pc": 9, "mode": "major"},
          "beats": clip.beats, "chords": clip.chords, "notes": clip.notes}
    return mix, sr, gt


# ---------------------------------------------------------------------------
# Clip 5: minor-key band mix, E minor, 126 BPM — barre/open minor voicings,
# piano stabs (the known precision-leakage source), no vocals.
# ---------------------------------------------------------------------------

def make_barre_band() -> tuple[np.ndarray, int, dict]:
    sr, tempo = 44100, 126.0
    period = 60.0 / tempo
    prog = ["E:min", "A:min", "D:maj", "E:min", "C:maj", "A:min", "B:min", "E:min",
            "C:maj", "D:maj", "E:min", "E:min"]
    clip = _Clip(duration_s=0.5 + len(prog) * 4 * period + 1.0, sr=sr, seed=75,
                 stems=("drums", "bass", "piano", "guitar"))
    spans = clip.chord_grid(prog, beats_per_chord=4, t0=0.5, period=period)
    _band_drums(clip, clip.beats, period)

    voicings = {lbl: _voicing(lbl) for lbl in set(prog)}
    for label, chord_beats in spans:
        v = voicings[label]
        root_pc, quality = _label_parts(label)
        bass_midi = 28 + ((root_pc - 4) % 12)  # anchored at E1
        for bi, b in enumerate(chord_beats):
            clip.pluck("bass", b, 0.9 * period, bass_midi + (7 if bi == 2 else 0), 0.6,
                       decay=2.0 / period, label=False)
            # guitar: full strum on 1, partial on 3 (top four strings)
            if bi == 0:
                for k, p in enumerate(v):
                    clip.pluck("guitar", b + 0.005 * k, 1.8 * period, p, 0.24, decay=0.9 / period)
            elif bi == 2:
                for k, p in enumerate(v[-4:]):
                    clip.pluck("guitar", b + 0.004 * k, 1.2 * period, p, 0.18, decay=1.2 / period)
            # piano stabs on the offbeats — chord tones an octave up
            if bi % 2 == 1:
                for iv in (0, 3 if quality == "min" else 4, 7):
                    clip.piano("piano", b, 1.0 * period, 52 + ((root_pc - 4) % 12) + 12 + iv, 0.26, decay=1.4 / period)
    mix = _finish_stereo(
        clip, ("drums", "bass", "piano", "guitar"),
        pans={"drums": 0.5, "bass": 0.52, "piano": 0.38, "guitar": 0.62},
        levels={"drums": 0.8, "bass": 0.7, "piano": 0.45, "guitar": 1.0},
    )
    gt = {"band": True, "key": {"tonic_pc": 4, "mode": "minor"},
          "beats": clip.beats, "chords": clip.chords, "notes": clip.notes}
    return mix, sr, gt


# ---------------------------------------------------------------------------
# Clip 6: vocal-dominated band mix, G major, 112 BPM — the engineered
# strict separation win. HPSS keeps ALL harmonic
# content, so the loud vocal line (MIDI 69-81, chosen to never collide
# with a guitar ground-truth pitch) floods the weight-free fallback's AMT
# with false positives; htdemucs routes it to the vocals stem. The gate
# asserts note precision WITH the checkpoint strictly beats precision
# without it.
# ---------------------------------------------------------------------------

def make_vocal_band() -> tuple[np.ndarray, int, dict]:
    sr, tempo = 44100, 112.0
    period = 60.0 / tempo
    prog = ["G:maj", "D:maj", "E:min", "C:maj", "G:maj", "C:maj", "D:maj", "G:maj"]
    clip = _Clip(duration_s=0.5 + 8 * 4 * period + 1.0, sr=sr, seed=76,
                 stems=("drums", "bass", "vocals", "guitar"))
    spans = clip.chord_grid(prog, beats_per_chord=4, t0=0.5, period=period)
    _band_drums(clip, clip.beats, period)

    voicings = {lbl: _voicing(lbl) for lbl in set(prog)}
    # busy vocal lead: two notes per beat, G-major tones strictly in 69-81
    voc_scale = [69, 71, 72, 74, 76, 79, 81]
    voc_line = [2, 4, 5, 4, 2, 1, 0, 1, 3, 5, 6, 5, 3, 2, 1, 2,
                4, 6, 5, 4, 2, 3, 1, 0, 2, 4, 3, 2, 0, 1, 2, 4]
    vocal_phrases = []
    for ci, (label, chord_beats) in enumerate(spans):
        v = voicings[label]
        root_pc, _ = _label_parts(label)
        bass_midi = 31 + ((root_pc - 7) % 12)  # anchored at G1
        for bi, b in enumerate(chord_beats):
            clip.pluck("bass", b, 0.9 * period, bass_midi + (7 if bi == 2 else 0), 0.6,
                       decay=2.0 / period, label=False)
            # guitar: fingerpick — bass string on the beat, two uppers after
            clip.pluck("guitar", b, 0.9 * period, v[0] if bi % 2 == 0 else v[1], 0.34, decay=1.2 / period)
            clip.pluck("guitar", b + 0.33 * period, 0.5 * period, v[-2], 0.22, decay=2.0 / period)
            clip.pluck("guitar", b + 0.66 * period, 0.5 * period, v[-1], 0.20, decay=2.0 / period)
            deg = voc_line[(ci * 4 + bi) % len(voc_line)]
            vocal_phrases.append((b + 0.05, 0.55 * period, voc_scale[deg]))
            vocal_phrases.append((b + 0.55 * period, 0.4 * period, voc_scale[(deg + 2) % 7]))
    _band_vocals(clip, vocal_phrases)

    mix = _finish_stereo(
        clip, ("drums", "bass", "vocals", "guitar"),
        pans={"drums": 0.5, "bass": 0.5, "vocals": 0.55, "guitar": 0.45},
        levels={"drums": 0.55, "bass": 0.6, "vocals": 1.2, "guitar": 0.9},
    )
    gt = {"band": True, "key": {"tonic_pc": 7, "mode": "major"},
          "beats": clip.beats, "chords": clip.chords, "notes": clip.notes}
    return mix, sr, gt


CLIPS = {
    "fingerpick": make_fingerpick,
    "picked_melody": make_picked_melody,
    "waltz_fingerpick": make_waltz_fingerpick,
    "strum_band": make_strum_band,
    "barre_band": make_barre_band,
    "vocal_band": make_vocal_band,
}


def generate(outdir: Path) -> dict[str, str]:
    """Render all clips + ground truth into outdir; → {filename: md5}."""
    from ..io.wav import write_wav

    outdir.mkdir(parents=True, exist_ok=True)
    digests: dict[str, str] = {}
    for name, fn in CLIPS.items():
        audio, sr, gt = fn()
        gt["generator_version"] = HELDOUT_VERSION
        wav = outdir / f"heldout_{name}.wav"
        write_wav(wav, audio, sr, pcm16=True)
        js = outdir / f"heldout_{name}.json"
        js.write_text(json.dumps(gt, separators=(",", ":"), sort_keys=True))
        for p in (wav, js):
            digests[p.name] = hashlib.md5(p.read_bytes()).hexdigest()
    manifest = "".join(f"{digests[k]}  {k}\n" for k in sorted(digests))
    (outdir / MANIFEST).write_text(manifest)
    return digests


def committed_manifest(heldout_dir: Path = HELDOUT_DIR) -> dict[str, str]:
    """{filename: md5} of the committed corpus' manifest."""
    return {
        line.split(maxsplit=1)[1].strip(): line.split(maxsplit=1)[0]
        for line in (heldout_dir / MANIFEST).read_text().splitlines() if line.strip()
    }


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--outdir", type=Path, help="render the corpus and its manifest into this directory")
    ap.add_argument("--check", action="store_true",
                    help="regenerate into a temporary directory and compare with the committed manifest")
    args = ap.parse_args(argv)
    if args.check:
        committed = committed_manifest()
        with tempfile.TemporaryDirectory() as td:
            fresh = generate(Path(td))
        bad = {k for k in committed if fresh.get(k) != committed[k]}
        bad |= set(fresh) - set(committed)
        if bad:
            print(f"MISMATCH: {sorted(bad)}")
            return 1
        print(f"ok: {len(fresh)} files byte-identical to the committed corpus")
        return 0
    if args.outdir is None:
        ap.error("give --outdir DIR or --check")
    digests = generate(args.outdir)
    for k in sorted(digests):
        print(f"{digests[k]}  {k}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
