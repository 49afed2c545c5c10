"""Seeded songs: bench.py's ``make_test_audio`` (a chord pad, a melody of
quarter notes with a click of noise at each onset, normalised to a peak of
0.9), with its chord loop, key, tempo, melody walk and noise drawn from the
seed, written as 44.1 kHz 16-bit stereo WAVs, the way songs are uploaded.

A traffic file fixes the set of songs: each one's length and tempo, and,
from its ``content_seed``, its key, chord loop and melody walk. The run's
seed orders the set and draws each song's clicks of noise, so every seed
asks for the same work and gives other bytes."""

from __future__ import annotations

import dataclasses
import struct
from pathlib import Path

import numpy as np
import torch

MAJOR = (0, 2, 4, 5, 7, 9, 11)
# chord loops as scale degrees (0 = I): I V vi IV is bench.py's G D Am C
LOOPS = ((0, 4, 5, 3), (5, 3, 0, 4), (0, 5, 3, 4), (0, 3, 4, 3))


@dataclasses.dataclass(frozen=True)
class Song:
    index: int
    seconds: float
    bpm: float
    path: Path


def song_plan(traffic: dict, seed: int) -> list[tuple[float, float, int]]:
    """(seconds, bpm, index in the traffic's set) of each of its songs, in the seed's order."""
    lengths = [float(s) for s in traffic["seconds"]]
    tempi = [float(b) for b in traffic["tempi_bpm"]]
    if len(lengths) != traffic["songs"] or len(tempi) != traffic["songs"]:
        raise ValueError("a traffic file gives one length and one tempo per song")
    return [(lengths[i], tempi[i], int(i)) for i in np.random.default_rng([seed, 0]).permutation(len(lengths))]


def make_song(seconds: float, bpm: float, rng: np.random.Generator, noise: np.random.Generator, sr: int = 44100,
              device: torch.device | str = "cpu") -> np.ndarray:
    """One song [n, 2] float32: make_test_audio's pad (a chord a bar, three
    voices at 0.12), melody (a quarter note at 0.3 decaying as exp(-3 t), a
    click of 0.25 x N(0, 1) from ``noise`` over its first 300 samples at
    22.05 kHz) and peak, at ``bpm`` in a key and chord loop drawn from
    ``rng``; the melody walks the scale by steps of -2 to 2. The right
    channel carries the melody at 0.8 of the left's level."""
    n = int(seconds * sr)
    beat = 60.0 / bpm
    key = int(rng.integers(12))
    loop = LOOPS[int(rng.integers(len(LOOPS)))]
    n_bars = int(np.ceil(seconds / (4 * beat)))
    n_notes = int(np.ceil(seconds / beat))
    # chord tones: the triad on each degree, rooted in MIDI 48..59
    chord_midi = np.zeros((n_bars, 3))
    for b in range(n_bars):
        d = loop[b % 4]
        root = 48 + (key + MAJOR[d]) % 12
        chord_midi[b] = [root + (MAJOR[(d + k) % 7] - MAJOR[d]) % 12 for k in (0, 2, 4)]
    walk = np.clip(np.cumsum(rng.integers(-2, 3, n_notes)) + 7, 0, 13)
    melody_midi = np.array([60 + key % 12 + 12 * (w // 7) + MAJOR[w % 7] for w in walk], dtype=np.float64)
    click_len = 300 * sr // 22050
    clicks = noise.standard_normal((n_notes, click_len))

    dev = torch.device(device)
    f64 = dict(dtype=torch.float64, device=dev)
    t = torch.arange(n, **f64) / sr
    bar = torch.clamp((t / (4 * beat)).long(), max=n_bars - 1)
    freqs = 440.0 * 2 ** ((torch.as_tensor(chord_midi, **f64) - 69) / 12)  # [bars, 3]
    pad = 0.12 * torch.sin(2 * np.pi * freqs[bar] * t[:, None]).sum(dim=1)
    note = torch.clamp((t / beat).long(), max=n_notes - 1)
    ts = t - note * beat
    f_mel = 440.0 * 2 ** ((torch.as_tensor(melody_midi, **f64) - 69) / 12)
    melody = 0.3 * torch.sin(2 * np.pi * f_mel[note] * ts) * torch.exp(-ts * 3)
    onsets = (torch.arange(n_notes, **f64) * beat * sr).long()
    idx = (onsets[:, None] + torch.arange(click_len, device=dev)).reshape(-1)
    noise = torch.zeros(n + click_len, **f64).index_put_((idx,), 0.25 * torch.as_tensor(clicks, **f64).reshape(-1), accumulate=True)[:n]
    y = torch.stack([pad + melody + noise, pad + 0.8 * melody + noise], dim=1)
    y = 0.9 * y / (y.abs().max() + 1e-9)
    return y.to(torch.float32).cpu().numpy()


def write_wav16(path: Path, x: np.ndarray, sr: int) -> None:
    """``x`` [n, channels] in [-1, 1] as a 16-bit PCM WAV."""
    body = np.clip(np.round(x * 32767.0), -32768, 32767).astype("<i2").tobytes()
    ch = x.shape[1]
    hdr = b"RIFF" + struct.pack("<I", 36 + len(body)) + b"WAVE"
    hdr += b"fmt " + struct.pack("<IHHIIHH", 16, 1, ch, sr, sr * ch * 2, ch * 2, 16)
    hdr += b"data" + struct.pack("<I", len(body))
    path.write_bytes(hdr + body)


def make_songs(traffic: dict, seed: int, out_dir: Path, device: torch.device | str = "cpu") -> list[Song]:
    """Every song of ``traffic`` for ``seed``, written to ``out_dir``."""
    sr = int(traffic["sample_rate"])
    songs = []
    for i, (seconds, bpm, k) in enumerate(song_plan(traffic, seed)):
        content, noise = np.random.default_rng([traffic["content_seed"], k]), np.random.default_rng([seed, 1, i])
        path = out_dir / f"song{i:02d}.wav"
        write_wav16(path, make_song(seconds, bpm, content, noise, sr, device), sr)
        songs.append(Song(i, seconds, bpm, path))
    return songs
