"""Smoke run of the PyTorch port on one NVIDIA GPU: build, check, time, drive.

    python3 chip_smoke.py          # every step
    python3 chip_smoke.py strum    # step 13b alone

1. Prints the card's name and power limit, and turns TF32 off.
2. Builds the seven kernels with nvcc into build/, one nvcc process per
   source, all started together: the median kernel (csrc/median_filter.cu,
   with the selection networks that ops/median.py generates) and the six
   sequential decoders (csrc/dbn_viterbi.cu, onset_wait.cu,
   banded_viterbi.cu, dense_viterbi.cu, salience_envelope.cu,
   constant_switch_viterbi.cu). Prints ptxas's registers and spills
   for each median instantiation (none may spill) and the min/max (FMNMX)
   per output of each network.
3. Holds the kernel against its plain PyTorch version exactly (a median
   selects an input element) at the main path's shapes, on random and
   tie-heavy inputs, on short and ragged extents at every network window, and
   at a window that takes the rank kernel; times the main-path shapes with
   CUDA events and prints each one's byte bound and issue bound (the
   network's min/max at 64 per SM per clock, at the SM clock that nvidia-smi
   reads under load).
4. Separation at full width: htdemucs (the checked-in htdemucs_6s
   checkpoint) on a held-out clip's 30 s bucket, 14 windows. Prints the
   program's warm time (CUDA events), its device-op count and device time
   (torch.profiler), its peak memory, the FLOP count of its convolutions and
   matrix products (torch's FlopCounterMode over this call's shapes) and the
   achieved TFLOP/s; holds each card stem against the port's CPU stem.
5. The main path: the CLI (``runtime/cli.py::main``, what a user runs) on
   the clip with the shipped settings, cold and then twice warm, each song
   with every kernel's launches counted from just before it: 8 median
   launches per song and, of the decoder kernels, 1 DBN, 2 onset wait-rule
   (content windows, calibration), 1 banded Viterbi (pYIN of the content
   windows), 1 dense Viterbi (CRF) and 1 salience envelope launch, no
   constant-switch Viterbi; no ``transcription_error``,
   ``stem_source`` guitar with the drums as beat source and no separation
   error, the whole artifact set in ``out/`` and ``work/``; one
   device-to-host copy per song (two where its strum segments took the
   device envelope pass) and each decoder kernel in the trace
   (profiler: the warm song's device ops and busy share); the
   CPU ``_pipeline_tail`` fed the card's own host features and native audio
   writes byte-equal artifacts. Prints the cold and warm wall and every
   ``profile.json`` stage.
6. Drives ``run_analysis`` with the shipped settings (separation on): 8
   median launches per song and the decoder launches of a CLI song, the
   guitar stem analysed, no stage error; the
   card's outputs against a CPU ``fused_analysis`` fed the card's own stems
   (discrete outputs and beat times equal). Times each stage and profiles one
   warm song. A CPU ``run_pipeline`` on its own stems must give the card's
   chords, key, time signature and beat times; its note agreement is printed.
7. Drives ``run_analysis`` with ``ENABLE_DEMUCS=False`` (the mix analysed):
   6 median launches per song and the decoder launches of a CLI song,
   discrete outputs equal to the CPU run's.
8. Serving (between 5 and 6): the job API (``runtime/server.py::serve``) on
   a free port with a data directory in build/: ``heldout_strum_band.wav``
   inline and ``heldout_picked_melody.wav`` queued and drained by
   ``worker.main(["--once"])`` on the card, 8 median launches and the
   decoder launches of a CLI song each (counted from just before each
   job); every artifact route of both jobs
   answers 200 with its content type; the inline job's ``result.json``
   equals the CLI's (``job_id`` aside).
9. The batch runner (after 8): ``transcribe_batch`` over the six held-out
   clips (all in the 30 s bucket) in chunks of 4 and 2 songs, cold and warm:
   8 median launches per chunk, one launch each of the DBN, dense (CRF)
   and banded Viterbi kernels and of the salience envelope, two of the
   onset kernel per chunk, and in the profiler 8 median launches and 1
   device-to-host copy per chunk; each row's stems within STEM_TOL of a 1-D
   ``separate_program`` of the row, and its fused outputs against
   ``fused_analysis`` on the row and the batch's stems; the artifact set of
   every song. Prints the batch's wall, audio seconds per wall second, busy
   share, each chunk alone in the profiler, and the six songs one at a time
   through ``run_pipeline`` with their chords, key, beats and notes against
   the batch's (printed, not checked). Then the first chunk again with
   ``CHORD_DETECTION_BACKEND=template``: a template song's decoder launches
   for the whole chunk (one constant-switch launch), each row's chord path
   equal to ``fused_analysis`` of the row on the chunk's stems. Step 3
   also holds the kernel exactly
   at every batched shape ([B, 1025, 1292], [B·20, 513, 130], [B, 513, 1292]
   for B = 4 and 2, both axes) and times each against its byte bound.
9a. The mesh (after 9, ``mesh_phase``): ``transcribe_batch`` over the six
    clips with ``mesh=default_mesh()`` (every card on one "data" axis): 8
    median launches per chunk and, per device shard, one DBN, one CRF, two
    onset, one banded Viterbi and one salience envelope launch;
    every row's discrete outputs and beat times
    equal to step 9's and its floats within FLOAT_TOL, the same artifact set;
    ``batched_fused_analysis`` over a 2-way "data" mesh of [cuda:0, cuda:0]
    at B = 6 and B = 5 (one zero pad row): 8 median launches and the same
    decoder launches per device shard as counted from the code, each row
    equal to the 1-way mesh's, the kernel
    exact at the shard shapes; htdemucs_6s with its weights sharded over a
    (1, 2) ("data", "model") mesh of [cuda:0, cuda:0]: the distributed
    parameters and the bytes in each shard, the 30 s bucket's separation
    within STEM_TOL of the unsharded module's, both warm times by events.
9b. bench.py's batch (after 9a, ``batch8_phase``): eight 30 s songs
    (``make_test_audio(30)``, bench.py's generator,
    plus 0.01 N(0, 1) noise from ``default_rng(7)``) through
    ``transcribe_batch``, two chunks of 4, cold then three times warm: 8
    median launches and a CLI song's decoder launches per chunk, 1
    device-to-host copy per chunk in the trace of one warm run, each row's
    stems and fused outputs as in step 9, every song's artifact set; prints
    audio-s per wall s of the fastest warm run.
10. Decode (after 7): which decoders the machine has (the native library
    built from native/, libmpg123, libmp3lame, the libavformat headers and
    the FFmpeg shim, an ffmpeg binary); the native resampler against
    scipy's. Inline jobs (``POST /v1/jobs?inline=1``): the clip's WAV bytes
    under a non-WAV suffix (found by its header) and, with libmp3lame and
    libmpg123 present, the clip encoded to MP3: 8 median launches and the
    decoder launches of a CLI song, no stage error, the WAV job's key and
    chord labels; and bytes no decoder takes: the job ends in the JAX
    package's error, with no launch of any kernel. A library that
    is absent is printed and only its check skipped.
11. The settings the fused features do not cover alone, each through the
    CLI on the clip under the shipped settings with one change, every
    kernel's launches counted from just before it:
    ``TRANSCRIPTION_MODE=notes`` (8 median launches, the decoders' of a CLI
    song), ``CHORD_DETECTION_BACKEND=template``
    with ``CHORD_VOCAB`` majmin7 and majmin7plus (8 each, no CRF decode; one
    constant-switch decode in the fused analysis, and for majmin7plus the
    tail's own chroma and decode: a second salience envelope and a second
    constant-switch decode; one warm majmin7 song traced), and 4 s / 2 s
    content windows (10: the tail's own window pass adds 2, and an onset and
    a pYIN launch). No stage error; the CPU ``_pipeline_tail`` on the
    card's host features writes the same artifacts (byte-equal where the
    tail does no device work; chord confidences and content metrics within
    FLOAT_TOL where it decodes again on the CPU). Prints each profile.json.
12. Degraded: ``fused_analysis`` made to raise under the shipped settings;
    ``run_pipeline`` on the card recomputes every stage: errors only
    ``analysis: ...``, 6 median launches (harmonic, calibration, content
    windows) and the decoder launches of a CLI song but no salience envelope
    (the Basic Pitch CNN and DeepChroma run instead), the full artifact set,
    and the beat times, chord labels, key
    and time signature of a CPU run of the same path on the card's stems.
    Prints the stage times, cold and warm.
13. Holds the kernel exactly at every shape these paths launched it at (the
    launched inputs, random and tie-heavy), and times each new shape.
13a. The long song (``long_phase``): bench.py's 180 s song
    (``make_test_audio(180)``, six 30 s buckets) under the shipped settings
    through the CLI, cold and then warm as bench.py runs it (up to 3
    warm-ups, then the minimum of 3), every kernel's launches counted from
    just before each song: 8 median launches and a CLI song's decoder
    launches, the guitar stem and the drums beat source, no stage error (a separation error,
    which the pipeline passes over to analyse the mix, fails the phase),
    the CLI song's artifact set, a score with measures, every profile.json
    stage; one warm song traced (device ops, busy share, 1 device-to-host
    copy, 2 with the strum envelope pass) and its peak device memory; ``run_analysis`` with its stems kept,
    the CPU ``fused_analysis`` on those stems against it (discrete outputs,
    beat_from_drums and beat times equal, floats within FLOAT_TOL, f16
    outputs within F16_TOL; one content window's onset density may be one
    onset apart, a knife edge printed with its envelope's margin), the card's
    stems within STEM_TOL of each stem's peak of the CPU separation of the
    same mix, warm ``run_analysis`` and separation times; the CPU
    ``run_pipeline_from_features`` on the card's features writes the card's
    beat times, chords, key and time signature. Then the median kernel held
    exactly on the song's launched inputs and at its new shapes ([1025,
    7752], [513, 7752], [120, 513, 130]), each timed beside its byte bound.
13b. The strum detector (``strum_phase``; alone: ``python3 chip_smoke.py
    strum``): the 16 clips of the ``clip30`` traffic (``benchmarks/core/
    songs.py``) at ``STRUM_SEEDS`` seeds and one 180 s song of the
    ``song180`` traffic through ``run_pipeline`` on the card under the
    ``mix`` settings (no separation), on each card route of the detector:
    guitar mode's chordal and hybrid segments of the 44.1 kHz audio, the
    same calls of ``run_guitar_mode`` again without the native audio or an
    envelope (on the mix resampled to 22.05 kHz), and accompaniment mode
    (the whole song one segment). Every segment's device flux (``strum_flux_batch``) against
    the host envelope of its audio: prints per route the largest gap in dB,
    the smallest decision margin in dB against ``GUARD_DB``, the fallbacks,
    the wall and peak device memory of the pass (a clip, and the 180 s
    song's) and of the host envelopes. Every segment's onsets must equal the
    host path's, and the largest gap must lie at least 100 times under
    ``GUARD_DB``.
14. Training (``train_phase``): htdemucs at the shipped width resumed from a
    copy of the checkpoint in build/ (10 steps of batch 4 through
    ``htdemucs_train.train``, 2 validation clips): every step's loss and
    time (CUDA events), the peak memory, the gates; its first batch's loss
    and global gradient norm against the CPU's within GRAD_RTOL (the norm
    with the L1 residual signs the card took, given to the CPU: a residual
    within float noise of zero takes either sign; the norms with each
    device's own signs are printed). The five other trainers at their
    shipped widths: 6 timed update steps on batches from each one's own
    dataset function (finite losses), then ``train()`` at a few steps and
    clips. The launches of each trainer are counted, of the median and of
    each decoder kernel (the gates decode beats with the DBN and chords with
    the CRF), and must be the counts in MEDIAN_LAUNCHES_BY_TRAINER and
    DECODER_LAUNCHES_BY_TRAINER (and the salience envelope's: the trainers'
    salience baselines); the median kernel is held exactly on the first 4
    launched inputs of every site and at each new shape (random and
    tie-heavy), and each is timed.
14a. Decoders (``decoders_phase``): every launch of the six decoder
    kernels from step 5 to step 14 was recorded (its shape, and its first
    two inputs at each shape). Each kernel must be bit-equal to its plain
    loop on the card at each of those shapes (the DBN's among them on the
    30 s bucket, [B, 3007], on the clip's true length and on the trainers'
    validation clips; the salience envelope's at [1, 88, 2584] and the
    trainers' clips; the constant-switch Viterbi's at [1, 49, 301] and
    majmin7plus' [1, 61, T]): on the launched inputs, random ones and
    tie-heavy ones (a constant and a two-level activation; every frame a
    candidate, runs of candidates; equal pYIN columns; equal emission
    columns with uniform transitions, and a NaN emission and an all-NaN row
    for the DBN (activations), pYIN and the CRF: a NaN is the maximum, as
    torch.argmax takes it, and a NaN output equals a NaN; a wait of 0 and of
    -1 for the onset rule; constant block maxima, a loud then
    silent row and a negative one whose padding holds the last block's
    maximum; equal emission columns, and costs exactly at the minimum plus
    the penalty; for the envelope and the constant-switch Viterbi a NaN a
    third of the way into a row and an all-NaN row, where a NaN is the
    maximum, and the minimum, as torch's take it). A batch chunk's envelope
    [4, 88, 2584] and the template chunk's [4, 49, 301] must be among the
    launched shapes. Each shape is timed: the kernel alone on inputs
    prepared once (CUDA events with and without the spin kernel, and its
    duration in the profiler), the wrapper with torch's preparation, and the
    plain loop on the card; beside the bound (adds at 128 and compares at 64
    per SM per clock at the clock of step 3, or bytes at 3.35 TB/s,
    whichever is larger) and the time per frame. The DBN, the onset rule,
    the CRF's dense Viterbi, the salience envelope and the constant-switch
    Viterbi are also held at the length of the JAX package's 180 s song
    (``LONG_SONG_S``): the DBN at [1, 18041] on the random, constant and
    two-level inputs and at [4, 18041] once on random inputs, the onset rule
    at [1, 7752], the dense Viterbi at [1, 1801, 25] (with its NaN cases),
    the envelope at [1, 88, 15504] and the constant-switch Viterbi at
    [1, 49, 1801] on their random and tie-heavy inputs (the long song of
    step 13a launches the [1, ...] ones but the constant-switch Viterbi's,
    so there they are held on its launched inputs too); the dense Viterbi
    also in its block layout at [2, 301, 61] (``OTHER_LAYOUT_SHAPES``, more
    states than a warp's lanes); the DBN's general layout at the tempo
    grids of ``DBN_GRIDS`` (at 100 fps 30–215, 20–300 and 10–400 BPM, and
    55–215 BPM at 200 fps: grids the register layouts do not take), [1, T]
    at the 30 s bucket's frames, on every input kind; each [1, ...] shape,
    the block layout and each grid timed (a plain loop of seconds once). No
    decoder kernel may spill registers (ptxas).
15. Prints the kernel table as one JSON line (the median kernel and the six
    decoder kernels, each decoder with its launches on its own path: the
    CLI under the shipped settings, the template backend for the
    constant-switch Viterbi; and each kernel's launches on the 180 s song
    and per chunk of the batch of eight), then the result line.

Each phase prints its wall time. Any failed phase raises, and the script
exits non-zero without a result. It imports nothing of JAX or of the JAX
package.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import importlib
import json
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

REPO = Path(__file__).resolve().parent
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))
from bench import make_test_audio  # noqa: E402  (bench.py imports only numpy at its top)

CLIP = REPO / "tests" / "data" / "heldout" / "heldout_strum_band.wav"
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)
# float min/max per SM per clock on compute capability 9.0 (CUDA C++
# Programming Guide, throughput of native arithmetic instructions)
FMNMX_PER_SM_PER_CLOCK = 64
FADD_PER_SM_PER_CLOCK = 128  # float32 adds, the same table
SPIN_CYCLES = 2_000_000  # about 1 ms of a spin kernel ahead of each timed call
# (shape, window, axis) of the median launches per song: HPSS of the
# 2048-point STFT (win 31), the content-window masks of the 20 batched 3 s
# windows' 1024-point STFTs (win 17) and the calibration masks of the
# 1024-point STFT (win 17), each along time and along frequency; with
# separation on, the beat fallback's HPSS of the mix adds the first shape
# twice more (8 launches)
MAIN_PATH_MEDIANS = [
    ((1025, 1292), 31, -1), ((1025, 1292), 31, -2),
    ((20, 513, 130), 17, -1), ((20, 513, 130), 17, -2),
    ((513, 1292), 17, -1), ((513, 1292), 17, -2),
]
MEDIAN_LAUNCHES_PER_SONG = len(MAIN_PATH_MEDIANS) + 2
# the batch runner's chunks: the same sites on [B, ...] (the content windows
# of B songs as one [B·20, ...] batch), 8 launches per chunk whatever B is
CHUNK_SONGS = (4, 2)
BATCHED_MEDIANS = [
    (shape, win, axis)
    for b in CHUNK_SONGS
    for shape, win in (((b, 1025, 1292), 31), ((b * 20, 513, 130), 17), ((b, 513, 1292), 17))
    for axis in (-1, -2)
]
# exactness only: extents shorter than the window or not a multiple of a
# thread's outputs (F = 1 and T = 1 among them), at every network window, and
# window 7, which takes the rank kernel
SHORT_SHAPES = [(1, 1), (1, 3), (1, 13), (1, 30), (3, 1), (13, 2), (2, 5, 37)]
RANK_CHECKS = [((3, 37, 70), 7), ((513, 1292), 7)]
FUSED_DEEP_KEYS = {
    "y_harm", "beat_activation", "amt_onset", "amt_frame", "chroma", "chord_energy", "chord_emissions",
    "dc_chroma", "crf_path", "crf_conf", "dbn_phases", "dbn_intervals", "strum_envelope", "content_starts",
    "content_metrics", "key_probs", "char_rms_median", "char_noise_rms", "char_centroid", "char_rolloff",
    "char_harm_ratio", "char_onset_density",
}
DISCRETE = ("crf_path", "dbn_phases", "dbn_intervals", "content_starts")
F16 = ("y_harm", "amt_onset", "amt_frame", "beat_activation")
# GPU against CPU: floats rtol 1e-3 / atol 1e-4 (cuFFT, cuBLAS and cuDNN sum
# in another order than the CPU kernels); f16 outputs within 2 f16 ulps
FLOAT_TOL = dict(rtol=1e-3, atol=1e-4)
F16_TOL = dict(rtol=2**-9, atol=2**-13)
# card stems against CPU stems: the largest error over the stem's peak (f32
# on both, TF32 off; cuDNN, cuBLAS and cuFFT sum in another order; the port
# and the JAX package agree within about 2e-6 on the CPU)
STEM_TOL = 1e-3
FP32_FLOPS_PER_S = 67e12  # H100 SXM, float32 outside the tensor cores (NVIDIA data sheet)
JOBS = REPO / "build" / "chip_smoke_jobs"  # git-ignored
STRUM_SEEDS = tuple(range(2_147_483_600, 2_147_483_610))  # step 13b's seeds of the clip30 traffic
BATCH_JOBS = REPO / "build" / "chip_smoke_batch"
SERVE_DATA = REPO / "build" / "chip_smoke_serve"
HELDOUT = sorted((REPO / "tests" / "data" / "heldout").glob("*.wav"))
# the job API's artifact routes and their content types (runtime/server.py::_ARTIFACTS)
ROUTES = {
    "result.json": "application/json", "musicxml": "application/vnd.recordare.musicxml+xml",
    "score.pdf": "application/pdf", "transcription.mid": "audio/midi", "note_events.csv": "text/csv",
    "tab_positions.json": "application/json",
}
# what run_pipeline writes for this clip under the shipped settings (guitar mode)
OUT_ARTIFACTS = {
    "result.json", "beat_times.json", "chords.json", "threshold_calibration.json", "content_segments.json",
    "strum_onsets.json", "chosen_shapes.json", "tab_positions.json", "note_events.csv", "result.musicxml",
    "transcription.mid", "score.ly", "score.pdf", "profile.json",
}
WORK_ARTIFACTS = {"audio_mono_44k.wav", "audio_harmonic.wav"}
STAGES = ("decode", "separation", "analysis", "beats", "calibration", "transcription", "beat_select", "chords", "key",
          "mode", "quantize", "artifacts", "export")


# The sequential decoders' kernels: name (that of its source, csrc/<name>.cu,
# and of its launch count, <name>_launches) → (port module, the JAX package's
# lax.scan the kernel replaces)
DECODERS = {
    "dbn_viterbi": ("audiotabs_tpu_torch.decode.dbn_beats", "audiotabs_tpu/decode/dbn_beats.py:90"),
    "onset_wait": ("audiotabs_tpu_torch.ops.onset", "audiotabs_tpu/ops/onset.py:70"),
    "banded_viterbi": ("audiotabs_tpu_torch.ops.pyin", "audiotabs_tpu/ops/pyin.py:171"),
    "dense_viterbi": ("audiotabs_tpu_torch.decode.viterbi", "audiotabs_tpu/decode/viterbi.py:79"),
    "salience_envelope": ("audiotabs_tpu_torch.models.basicpitch", "audiotabs_tpu/models/basicpitch.py:201"),
    "constant_switch_viterbi": ("audiotabs_tpu_torch.decode.viterbi", "audiotabs_tpu/decode/viterbi.py:46"),
}
# launches per song of the CLI under the shipped settings: the DBN, the onset
# wait rule of the content windows and of the calibration, pYIN's Viterbi of
# the content windows, the CRF decode, the salience envelope; no
# constant-switch decode (the template backend's); in a batch chunk or a
# mesh shard of b songs the same, whatever b is
DECODER_LAUNCHES_PER_SONG = {"dbn_viterbi": 1, "onset_wait": 2, "banded_viterbi": 1, "dense_viterbi": 1,
                             "salience_envelope": 1, "constant_switch_viterbi": 0}
# the JAX package's north-star song (bench.py's long_song_wall_s): the DBN,
# the onset rule, the CRF's dense Viterbi, the salience envelope and the
# constant-switch Viterbi (majmin7's 49 states) are also held and timed at
# its length, [1, ...] on the tie-heavy inputs too and the DBN at [4, T]
# once; the plain loops take up to seconds there, so each is timed once
LONG_SONG_S = 180
# shapes no path launches that take another layout of a kernel: the dense
# Viterbi's block layout (more states than a warp's 32 lanes), held on the
# inputs named and timed once
OTHER_LAYOUT_SHAPES = {
    "dense_viterbi": {(2, 301, 61): ("random", "equal columns, uniform transitions", "one NaN", "NaN row")},
}
# tempo grids (min_bpm, max_bpm, fps) past the DBN's register layouts, which
# its general layout takes (as the JAX scan takes any grid): 174 tempi x 200
# phases, 165 x 219, 281 x 300 (the score in shared memory) and 586 x 600 (in
# device memory); each held at the 30 s bucket's frames at its fps, [1, T],
# on every input kind, and timed once
DBN_GRIDS = [(30.0, 215.0, 100), (55.0, 215.0, 200), (20.0, 300.0, 100), (10.0, 400.0, 100)]
DBN_GRID_CASES = ("random", "constant", "two levels", "one NaN", "NaN row")
LONG_JOBS = REPO / "build" / "chip_smoke_long"  # git-ignored
BATCH8_JOBS = REPO / "build" / "chip_smoke_batch8"
BATCH8_SONGS = 8  # bench.py's batch: eight 30 s songs through transcribe_batch


def beat_frames(seconds: float, sr: int = 22050, fps: int = 100) -> int:
    """Frames of the beat activation of ``seconds`` of audio at the analysis
    rate (``models/beat_rnn.py::spectral_features``: hop sr // fps, centred)."""
    return int(seconds * sr) // (sr // fps) + 1


def hcqt_frames(seconds: float, sr: int = 22050, hop: int = 256) -> int:
    """Frames of the hCQT, and so of the salience, of ``seconds`` of audio (``models/basicpitch.py::HOP``, centred)."""
    return int(seconds * sr) // hop + 1


def onset_frames(seconds: float, sr: int = 22050, hop: int = 512) -> int:
    """Frames of the calibration's onset envelope of ``seconds`` of audio (``runtime/fused.py``: hop 512, centred)."""
    return int(seconds * sr) // hop + 1


def chroma_frames(seconds: float, sr: int = 22050, fps: int = 10) -> int:
    """Frames of the chord chroma and emissions of ``seconds`` of audio (``runtime/fused.py``: hop sr / 10)."""
    return int(seconds * sr) // round(sr / fps) + 1


def decoder_shapes_at(seconds: float) -> dict[str, dict[tuple, tuple[str, ...]]]:
    """The shapes of one song of ``seconds`` for the kernels checked at the
    long song's length, each with the inputs to hold it on."""
    return {
        "dbn_viterbi": {(1, beat_frames(seconds)): ("random", "constant", "two levels"), (4, beat_frames(seconds)): ("random",)},
        "onset_wait": {(1, onset_frames(seconds)): ("random", "all candidates", "runs", "wait 0", "wait -1")},
        "dense_viterbi": {(1, chroma_frames(seconds), 25): ("random", "equal columns, uniform transitions", "one NaN", "NaN row")},
        "salience_envelope": {(1, 88, hcqt_frames(seconds)): ("random", "constant block maxima", "loud then silent", "negative",
                                                               "one NaN", "NaN row")},
        "constant_switch_viterbi": {(1, 49, chroma_frames(seconds)): ("random", "equal columns", "at min + penalty", "one NaN",
                                                                     "NaN row")},
    }


def cuda_ms(fn, reps: int = 30, warmup: int = 3, spin: bool = True) -> float:
    """Median over ``reps`` of one call's time on the card (CUDA events).

    With ``spin``, a spin kernel is queued first, so the card is busy while
    the host queues the call and the events time the card's work alone.
    Without it, the time also holds the host's gap between the start event
    and the launch, which is what a single launch on an idle card costs."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        if spin:
            torch.cuda._sleep(SPIN_CYCLES)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms(fn, reps: int = 20, key: str = "median_", tries: int = 3) -> float | None:
    """Mean duration of one kernel whose name holds ``key`` in
    torch.profiler's device trace (the kernel alone, without launch gaps),
    over the launches the trace holds. A trace that holds none is taken
    again, up to ``tries`` times (a short trace sometimes comes back
    without its kernels); None if none held one."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        durations = [stop - start for name, start, stop in device_events(prof) if key in name]
        if durations:
            return sum(durations) / len(durations) / 1e3
    return None


def wall_s(fn, reps: int = 3) -> float:
    """Median wall time of a call that ends in a device synchronise."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def tie_heavy(rng, shape) -> np.ndarray:
    """Four levels, and runs of zeros along both axes."""
    x = rng.integers(0, 4, shape).astype(np.float32) / 4
    x[..., rng.random(shape[-1]) < 0.3] = 0.0
    x[..., rng.random(shape[-2]) < 0.3, :] = 0.0
    return x


def check_exact(median, x: np.ndarray, win: int, axis: int) -> float:
    xc = torch.from_numpy(x).cuda()
    got = median.median_filter(xc, win, axis)
    ref = median.median_filter_plain(xc, win, axis)
    torch.cuda.synchronize()
    err = float((got - ref).abs().max())
    if not torch.equal(got, ref):
        raise AssertionError(f"median kernel differs from the plain version at {x.shape} win {win} axis {axis}: {err}")
    return err


def sm_clock_under_load(busy, seconds: float = 1.5) -> list[float]:
    """SM clocks (MHz) that nvidia-smi samples while the card runs ``busy``."""
    proc = subprocess.Popen(["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,nounits", "-lms", "50"],
                            stdout=subprocess.PIPE, text=True)
    try:
        t_end = time.perf_counter() + seconds
        while time.perf_counter() < t_end:
            busy()
        torch.cuda.synchronize()
    finally:
        proc.terminate()
        out = proc.communicate(timeout=30)[0]
    samples = [float(v) for v in out.split()]
    return samples[len(samples) // 2 :]  # the first half may predate the load


def check_kernel(median) -> dict:
    rng = np.random.default_rng(0)
    usage = median.ptxas_usage()
    for kernel, u in sorted(usage.items()):
        print(f"ptxas {kernel}: {u}")
        if u.get("spill_stores", 0) or u.get("spill_loads", 0):
            raise AssertionError(f"{kernel} spills registers: {u}")
    fmnmx = {w: median.median_schedule(w, k).ops_per_output for w, k in median.NET_OUTPUTS.items()}
    print(f"FMNMX per output by window (k adjacent outputs): {fmnmx} ({median.NET_OUTPUTS}); odd-even sort: 930 at 31, 272 at 17")
    if fmnmx[31] > 110 or fmnmx[17] > 60:
        raise AssertionError(f"min/max per output above 110 / 60: {fmnmx}")

    big = torch.rand(8, 1025, 1292, device="cuda")
    clocks = sm_clock_under_load(lambda: median.median_filter(big, 31, -1))
    max_mhz = float(subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
                                   capture_output=True, text=True, check=True).stdout.split()[0])
    mhz = statistics.median(clocks) if clocks else max_mhz  # no sample: the bound at the highest clock
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    issue_rate = n_sm * FMNMX_PER_SM_PER_CLOCK * mhz * 1e6  # min/max per second
    print(f"sm clock under load: median {mhz} MHz of {len(clocks)} samples {clocks}, max clock {max_mhz} MHz, {n_sm} SMs")
    del big

    total = {"ms": 0.0, "single_ms": 0.0, "device_ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "issue_bound_ms": 0.0, "max_abs_err": 0.0}
    per_launch = {}
    batched = {}
    for shape, win, axis in MAIN_PATH_MEDIANS + BATCHED_MEDIANS:
        x_np = np.abs(rng.standard_normal(shape)).astype(np.float32)
        err = max(check_exact(median, x_np, win, axis), check_exact(median, tie_heavy(rng, shape), win, axis))
        x = torch.from_numpy(x_np).cuda()
        row = dict(
            shape=list(shape), win=win, axis=axis,
            ms=cuda_ms(lambda: median.median_filter(x, win, axis)),
            single_ms=cuda_ms(lambda: median.median_filter(x, win, axis), spin=False),
            device_ms=device_ms(lambda: median.median_filter(x, win, axis)),
            plain_ms=cuda_ms(lambda: median.median_filter_plain(x, win, axis), reps=20),
            bound_ms=2 * x.numel() * 4 / HBM_BYTES_PER_S * 1e3,  # read once, write once
            issue_bound_ms=fmnmx[win] * x.numel() / issue_rate * 1e3,
            max_abs_err=err,
        )
        print("median", json.dumps(row))
        label = f"{'x'.join(map(str, shape))} win {win} axis {axis}"
        if (shape, win, axis) in MAIN_PATH_MEDIANS:
            per_launch[label] = row["ms"]
            for k in ("ms", "single_ms", "device_ms", "plain_ms", "bound_ms", "issue_bound_ms"):
                total[k] = None if total[k] is None or row[k] is None else total[k] + row[k]
        else:
            batched[label] = {k: row[k] for k in ("ms", "device_ms", "plain_ms", "bound_ms", "issue_bound_ms")}
        total["max_abs_err"] = max(total["max_abs_err"], err)

    cases = [(s, w) for w in sorted(median.NET_OUTPUTS) for s in SHORT_SHAPES] + RANK_CHECKS
    for shape, win in cases:
        for axis in (-1, -2):
            for x_np in (np.abs(rng.standard_normal(shape)).astype(np.float32), tie_heavy(rng, shape)):
                total["max_abs_err"] = max(total["max_abs_err"], check_exact(median, x_np, win, axis))
    print(f"median exact on {len(cases) * 4} short, ragged and rank-kernel cases (random and tie-heavy, both axes)")
    print(f"median per song ({len(MAIN_PATH_MEDIANS)} main-path launches): kernel {total['ms']:.4f} ms "
          f"({total['single_ms']:.4f} ms timed without the spin kernel, {total['device_ms']} ms of kernel time in the profiler), plain {total['plain_ms']:.4f} ms, "
          f"byte bound {total['bound_ms']:.4f} ms at {HBM_BYTES_PER_S / 1e12} TB/s, issue bound {total['issue_bound_ms']:.4f} ms at {mhz} MHz")
    per_chunk = {}
    for b in CHUNK_SONGS:
        # the chunk's 8 launches: its 6 sites, and the mix's HPSS pair again
        rows = [batched[f"{'x'.join(map(str, shape))} win {win} axis {axis}"] for shape, win, axis in BATCHED_MEDIANS if shape[0] in (b, b * 20)]
        rows += rows[:2]
        per_chunk[b] = {k: None if any(r[k] is None for r in rows) else sum(r[k] for r in rows) for k in rows[0]}
        print(f"median per chunk of {b} songs (8 launches): kernel {per_chunk[b]['ms']:.4f} ms by events, {per_chunk[b]['device_ms']} ms in the profiler, "
              f"plain {per_chunk[b]['plain_ms']:.4f} ms, byte bound {per_chunk[b]['bound_ms']:.4f} ms, issue bound {per_chunk[b]['issue_bound_ms']:.4f} ms")
    total.update(per_launch=per_launch, batched=batched, per_chunk=per_chunk, fmnmx_per_output=fmnmx, sm_clock_mhz=mhz, ptxas=usage)
    return total


@torch.inference_mode()
def stage_times(y_np: np.ndarray, sr: int) -> dict:
    """Warm wall time of separation and of each stage of fused_analysis, called alone on its real inputs."""
    from audiotabs_tpu_torch.accompaniment.strum import _onset_strength_median
    from audiotabs_tpu_torch.analysis.content_classifier import _window_metrics
    from audiotabs_tpu_torch.chords.extract import salience_chroma
    from audiotabs_tpu_torch.decode.dbn_beats import _dbn_forward
    from audiotabs_tpu_torch.models import basicpitch, beat_rnn, crf_chords, deepchroma, htdemucs, key_cnn
    from audiotabs_tpu_torch.ops.hpss import hpss, hpss_masks
    from audiotabs_tpu_torch.ops.onset import onset_detect_frames, onset_strength
    from audiotabs_tpu_torch.ops.spectral import stft
    from audiotabs_tpu_torch.runtime.fused import load_models

    dev = torch.device("cuda")
    m = load_models(dev)
    y = torch.from_numpy(y_np).to(dev)
    y_harm, _ = hpss(y)
    act = beat_rnn.beat_activation(y, sr, m.beat)
    dc = deepchroma.apply(m.deepchroma, deepchroma.features(y_harm, sr)[:301])
    crf_feats = dc / dc.norm(dim=1, keepdim=True).clamp(min=1e-9)
    n = len(y_np)
    starts = list(range(0, n - sr // 2, sr + sr // 2))
    windows = torch.stack([torch.nn.functional.pad(y[s : s + 3 * sr], (0, max(0, s + 3 * sr - n))) for s in starts])
    S1024 = torch.abs(stft(y, n_fft=1024, hop=512))
    stages = {
        "separation (htdemucs, 14 windows)": lambda: htdemucs.separate_stems_device(y, sr, shifts=1),
        "hpss (stft, 2 median launches, 2 istft; twice a song with separation on)": lambda: hpss(y),
        "blstm (features + ensemble)": lambda: beat_rnn.beat_activation(y, sr, m.beat),
        "dbn (dbn_viterbi kernel: forward + backtrack)": lambda: _dbn_forward(act),
        "hcqt + basic pitch cnn": lambda: basicpitch.cnn_apply(m.basicpitch, basicpitch.hcqt(y_harm, sr)),
        "salience posteriors + chroma": lambda: salience_chroma(basicpitch.salience_posteriors(y_harm, sr)[1], 301),
        "deepchroma (features + dnn)": lambda: deepchroma.apply(m.deepchroma, deepchroma.features(y_harm, sr)[:301]),
        "crf (emissions + dense_viterbi kernel)": lambda: crf_chords.decode(m.crf, crf_feats),
        "key cnn (features + cnn)": lambda: key_cnn.apply(m.key, key_cnn.features(y_harm, sr)),
        "strum envelope": lambda: _onset_strength_median(y, sr, 512),
        "content windows (pyin with banded_viterbi, onset_wait, 2 median launches)": lambda: _window_metrics(windows, sr),
        "calibration masks (2 median launches)": lambda: hpss_masks(S1024, 17, 17),
        "calibration onsets (envelope + onset_wait kernel)": lambda: onset_detect_frames(onset_strength(y, sr, hop=512, n_fft=1024), delta=0.5, wait=4),
    }
    out = {}
    for name, fn in stages.items():
        out[name] = wall_s(fn)
        print(f"stage {name}: {out[name] * 1e3:.2f} ms")
    return out


# The profiler keeps running this long after a traced call's last synchronise:
# with the trace stopped right after it, a chunk's last device records (its one
# device-to-host copy among them) were missing from three traces in a row.
TRACE_TAIL_S = 0.5


def device_events(prof) -> list[tuple[str, float, float]]:
    """The trace's device activities (kernels, copies, sets) as (name, start µs,
    end µs), read from the Chrome trace the profiler writes: torch's Python
    event list takes minutes to build for a batch's hundreds of thousands of
    launches."""
    path = REPO / "build" / "chip_smoke_trace.json"
    prof.export_chrome_trace(str(path))
    try:
        trace = json.loads(path.read_text())
    finally:
        path.unlink()
    return [(e["name"], e["ts"], e["ts"] + e["dur"]) for e in trace["traceEvents"]
            if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]


def busy_ms(events: list) -> float:
    """Time during which at least one device activity ran (the union of their intervals), ms."""
    total, end = 0.0, float("-inf")
    for start, stop in sorted((start, stop) for _, start, stop in events):
        if stop > end:
            total += stop - max(start, end)
            end = stop
    return total / 1e3


def print_top(label: str, events: list, n: int = 8) -> None:
    by_name = collections.defaultdict(lambda: [0, 0.0])
    for name, start, stop in events:
        by_name[name][0] += 1
        by_name[name][1] += stop - start
    for name, (count, us) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[:n]:
        print(f"{label}: {name[:80]} count {count} device {us / 1e3:.2f} ms")


def profile_busy_share(run) -> dict:
    """Device busy share of one warm song from torch.profiler (CUPTI): the
    song's device ops, busy share, device-to-host copies and the launches of
    each decoder kernel in the trace."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        time.sleep(TRACE_TAIL_S)
    events = device_events(prof)
    dtoh = sum(name.startswith("Memcpy DtoH") for name, _, _ in events)
    decoders = {name: sum(f"{name}_kernel" in e for e, _, _ in events) for name in DECODERS}
    decoder_ms = {name: sum(stop - start for e, start, stop in events if f"{name}_kernel" in e) / 1e3 for name in DECODERS}
    print(f"profile: device-to-host copies per song {dtoh}, decoder kernels in the trace {decoders}, their device ms {decoder_ms}")
    if not events:
        print("profile: no device time in the trace; busy share not measured")
        return {"dtoh": dtoh, "decoders": decoders, "decoder_ms": decoder_ms, "device_ops": 0, "busy_share": None, "wall_ms": wall * 1e3}
    busy = busy_ms(events)
    print(f"profile: wall {wall * 1e3:.1f} ms, device busy {busy:.1f} ms (kernel time summed {sum(stop - start for _, start, stop in events) / 1e3:.1f} ms), "
          f"busy share {busy / 1e3 / wall:.3f}, device ops {len(events)}")
    print_top("profile median", [e for e in events if "median_" in e[0]])
    print_top("profile decoders", [e for e in events if any(f"{name}_kernel" in e[0] for name in DECODERS)])
    print_top("profile top", events)
    return {"dtoh": dtoh, "decoders": decoders, "decoder_ms": decoder_ms, "device_ops": len(events), "busy_ms": busy, "busy_share": busy / 1e3 / wall,
            "wall_ms": wall * 1e3}


def compare_with_cpu(what: str, cpu: dict, card: dict, quiet: bool = False) -> None:
    """Discrete outputs equal, floats within FLOAT_TOL, f16 outputs within F16_TOL."""
    if set(cpu) != set(card):
        raise AssertionError(f"{what}: output keys differ: {sorted(set(cpu) ^ set(card))}")
    for k in sorted(cpu):
        a, b = cpu[k], card[k]
        if k in DISCRETE or a.dtype == np.bool_:
            if not np.array_equal(a, b):
                raise AssertionError(f"{what}: {k} differs between cuda and cpu at {int((a != b).sum())} of {a.size}")
            continue
        d = float(np.abs(a.astype(np.float64) - b.astype(np.float64)).max()) if a.size else 0.0
        if not quiet:
            print(f"{what} {k}: max abs diff {d:.3g}")
        np.testing.assert_allclose(b.astype(np.float32), a.astype(np.float32), err_msg=f"{what} {k}", **(F16_TOL if k in F16 else FLOAT_TOL))


def check_outputs(feats: dict, beats: np.ndarray, keys: set) -> None:
    if set(feats) != keys:
        raise AssertionError(f"output keys differ: {sorted(set(feats) ^ keys)}")
    for k, v in feats.items():
        if v.dtype.kind == "f" and not np.isfinite(v).all():
            raise AssertionError(f"non-finite values in {k}")
    if beats.size == 0:
        raise AssertionError("no beats")
    print(f"beats: {beats.size}, first {beats[:4].tolist()}, crf states {np.unique(feats['crf_path']).tolist()}, key argmax {int(np.argmax(feats['key_probs']))}")


def drive(settings, expect_launches: int) -> tuple:
    """run_analysis on the card: cold, then twice warm, each song's launches
    counted from just before it (the decoders' per song as the CLI's)."""
    from audiotabs_tpu_torch.runtime.pipeline import run_analysis

    times = []
    for _ in range(3):
        count = Launches()
        t0 = time.perf_counter()
        feats, beats, info = run_analysis(CLIP, device="cuda", settings=settings)
        times.append(time.perf_counter() - t0)
        if count.median != expect_launches:
            raise AssertionError(f"median kernel launched {count.median} times in one song, expected {expect_launches}")
        decoders = count.expect(DECODER_LAUNCHES_PER_SONG, "run_analysis song")
    print(f"run_analysis on {CLIP.name} (ENABLE_DEMUCS={settings.ENABLE_DEMUCS}): cold {times[0]:.3f} s, "
          f"warm {times[1]:.3f} s / {times[2]:.3f} s, median launches per song {count.median}, decoder launches {decoders}, {info}")
    return feats, beats, info, count.median


def read_out(job: Path) -> dict:
    """A job's ``out/`` files: JSON parsed, the rest as bytes."""
    return {p.name: json.loads(p.read_text()) if p.suffix == ".json" else p.read_bytes() for p in sorted((job / "out").iterdir())}


class Capture:
    """Wraps a module function and keeps what its last call returned and how
    long it took, and the arguments and result of every call (``calls``)."""

    def __init__(self, module, name: str):
        self.module, self.name, self.fn, self.last, self.seconds = module, name, getattr(module, name), None, None
        self.calls = []

    def __enter__(self):
        def keep(*args, **kwargs):
            t0 = time.perf_counter()
            self.last = self.fn(*args, **kwargs)
            self.seconds = time.perf_counter() - t0
            self.calls.append((args, kwargs, self.last))
            return self.last

        setattr(self.module, self.name, keep)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.fn)
        return False


def strum_phase(card: str, seeds=None) -> dict:
    """Step 13b: the strum detector's device flux against its host envelope,
    segment by segment, on its three card routes: the clip30 traffic at
    ``seeds`` and one 180 s song of the song180 traffic through
    ``run_pipeline`` in guitar mode (each chordal and hybrid segment of the
    native 44.1 kHz audio) and in accompaniment mode (the whole song one
    segment), and each guitar-mode call again without the native audio or an
    envelope, on the mix resampled to 22.05 kHz (the segments of the
    analysis-rate signal). Also the pass's wall and its peak device memory
    above what was allocated before it."""
    sys.path.insert(0, str(REPO / "benchmarks"))
    from core import songs
    from scipy.signal import resample_poly

    from audiotabs_tpu_torch import tracing
    from audiotabs_tpu_torch.accompaniment import strum
    from audiotabs_tpu_torch.config import Settings
    from audiotabs_tpu_torch.runtime import modes, pipeline

    clip30 = json.loads((REPO / "benchmarks" / "traffic" / "clip30.json").read_text())
    song180 = json.loads((REPO / "benchmarks" / "traffic" / "song180.json").read_text())
    song180 = {**song180, "songs": 1, "seconds": song180["seconds"][:1], "tempi_bpm": song180["tempi_bpm"][:1]}
    guitar = dataclasses.replace(Settings(), ENABLE_DEMUCS=False)
    accompaniment = dataclasses.replace(guitar, TRANSCRIPTION_MODE="accompaniment")
    seeds = STRUM_SEEDS if seeds is None else seeds
    routes = {r: dict(segments=0, gap=0.0, margin=np.inf, fallbacks=0, differ=0, host_s=[])
              for r in ("guitar 44.1 kHz", "guitar 22.05 kHz", "accompaniment")}
    passes = []  # (route, audio seconds, frame rows, wall s, peak bytes above the allocated)
    batch = strum.strum_flux_batch

    def measured(y, sr, bounds, device, **kw):
        cuda = torch.device(device).type == "cuda"
        if cuda:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        out = batch(y, sr, bounds, device, **kw)
        peak = torch.cuda.max_memory_allocated() - base if cuda else 0
        passes.append([None, len(y) / sr, sum(1 + max(b - a, 2048) // 512 for a, b in bounds), time.perf_counter() - t0, peak])
        return out

    def held(route: str, name: str, run) -> list:
        """``run()`` with the detector's calls kept; each call's flux held
        against the host envelope of its audio, its margins and its onsets."""
        r, before, n_pass = routes[route], tracing.counters().get("strum_fallbacks", 0), len(passes)
        with Capture(modes, "detect_strum_onsets") as det:
            run()
        r["fallbacks"] += tracing.counters().get("strum_fallbacks", 0) - before
        if not det.calls or len(passes) != n_pass + 1:
            raise AssertionError(f"{route} {name}: {len(det.calls)} strum segments, {len(passes) - n_pass} device passes")
        passes[-1][0] = route
        t_host = 0.0
        for args, kwargs, got in det.calls:
            y, sr = args
            flux = kwargs["flux"]
            if flux is None:
                raise AssertionError(f"{route} {name}: a strum segment had no device flux")
            t0 = time.perf_counter()
            host = strum._onset_strength_median_host(y, sr)
            t_host += time.perf_counter() - t0
            r["gap"] = max(r["gap"], float(np.abs(flux - host).max()))
            n_env = len(y) // 512 + 1
            top = float(np.abs(flux[:n_env]).max())
            _, m = strum._strum_times(strum._normalize(flux[:n_env]), sr, 512, kwargs.get("onset_delta", 0.2),
                                      kwargs.get("min_interval_s", 0.12), margins=True)
            r["margin"] = min(r["margin"], m * top)
            ref = strum.detect_strum_onsets(y, sr, **{**kwargs, "flux": None})
            r["differ"] += ref.dtype != got.dtype or ref.tobytes() != got.tobytes()
            r["segments"] += 1
        r["host_s"].append(t_host)
        return det.calls

    def song(clip, name: str) -> None:
        with Capture(modes, "run_guitar_mode") as mode:
            held("guitar 44.1 kHz", name, lambda: pipeline.run_pipeline(root / "job", clip.path, device="cuda", settings=guitar))
        shutil.rmtree(root / "job", ignore_errors=True)
        (args, kwargs, _), = mode.calls
        # the route's 22.05 kHz signal is the harmonic part, whose flux is 0 in these songs without attacks (every
        # segment falls back); the mix resampled to it holds the clicks' attacks
        (y_nat, sr_nat), sr = kwargs["y_strum"], args[1]
        y = resample_poly(y_nat, sr, sr_nat).astype(np.float32)
        held("guitar 22.05 kHz", name, lambda: modes.run_guitar_mode(y, *args[1:], **{**kwargs, "y_strum": None, "strum_envelope": None}))
        held("accompaniment", name, lambda: pipeline.run_pipeline(root / "job", clip.path, device="cuda", settings=accompaniment))
        shutil.rmtree(root / "job", ignore_errors=True)

    root = Path(tempfile.mkdtemp(prefix="strum_", dir=REPO / "build"))
    strum.strum_flux_batch = measured
    try:
        for seed in seeds:
            clips = songs.make_songs(clip30, seed, root, device="cuda")
            for clip in clips:
                song(clip, f"seed {seed} {clip.path.name}")
                clip.path.unlink()
        n_clips = len(passes) // 3
        (long,) = songs.make_songs(song180, seeds[0], root, device="cuda")
        song(long, f"seed {seeds[0]} the 180 s song")
    finally:
        strum.strum_flux_batch = batch
        shutil.rmtree(root, ignore_errors=True)
    for route, r in routes.items():
        clip_ms = [1e3 * p[3] for p in passes[: 3 * n_clips] if p[0] == route]
        clip_peak = max(p[4] for p in passes[: 3 * n_clips] if p[0] == route)
        (_, _, rows, wall, peak), = (p for p in passes[3 * n_clips :] if p[0] == route)
        r.update(pass_ms=statistics.median(clip_ms), peak_bytes=clip_peak, long_rows=rows, long_ms=1e3 * wall, long_peak_bytes=peak)
        print(f"strum {route}: {len(seeds)} seeds x {clip30['songs']} clips and a 180 s song, {r['segments']} segments; largest "
              f"device-host gap {r['gap']:.3e} dB, smallest decision margin {r['margin']:.3e} dB, guard {strum.GUARD_DB:.1e} dB "
              f"({strum.GUARD_DB / max(r['gap'], 1e-30):.0f}x the gap); {r['fallbacks']} fallbacks; onsets differ in {r['differ']}; "
              f"device pass {r['pass_ms']:.2f} ms a clip (median), peak {r['peak_bytes'] / 2**20:.1f} MiB; host envelopes "
              f"{1e3 * statistics.median(r['host_s'][:n_clips]):.2f} ms a clip; the 180 s song: {rows} frame rows, pass "
              f"{r['long_ms']:.2f} ms, peak {peak / 2**20:.1f} MiB, host envelopes {1e3 * r['host_s'][-1]:.2f} ms [{card}]")
    for route, r in routes.items():
        if r["differ"]:
            raise AssertionError(f"strum {route}: onsets differ from the host path's in {r['differ']} segments")
        if r["gap"] * 100 > strum.GUARD_DB:
            raise AssertionError(f"strum {route}: the largest gap {r['gap']:.3e} dB is not 100 times under the guard {strum.GUARD_DB} dB")
    return {route: {k: v for k, v in r.items() if k != "host_s"} for route, r in routes.items()}


def traced_copies(run, what: str) -> tuple[dict, int]:
    """One song traced (``profile_busy_share``, taken again while its trace
    holds fewer device-to-host copies than it should: see retrace), and the
    copies it should hold: the fused analysis' one, and one more where the
    song's strum segments took the device envelope pass."""
    from audiotabs_tpu_torch.accompaniment import strum

    with Capture(strum, "strum_flux_batch") as passes:
        traced = retrace(lambda: profile_busy_share(run), lambda p: p["dtoh"] < 1 + bool(passes.calls),
                         f"{what}'s trace lacks a device-to-host copy")
    return traced, 1 + bool(passes.calls)


def cli_phase(recorder: RecordLaunches, card: str) -> dict:
    """The main path: the port's CLI on the card under the shipped settings,
    cold and then twice warm, every kernel's launches counted from just
    before each song to just after it; the artifacts checked, one warm
    song profiled, and the CPU tail run on the card's own host features."""
    from audiotabs_tpu_torch.config import Settings
    from audiotabs_tpu_torch.io.wav import decode_for_analysis, peak_normalize
    from audiotabs_tpu_torch.runtime import cli, pipeline

    shutil.rmtree(JOBS, ignore_errors=True)
    walls, cli_walls = [], []
    with Capture(pipeline, "features_to_host") as feats, Capture(pipeline, "run_pipeline") as result:
        for run in range(3):
            job = JOBS / f"cli{run}"
            count = Launches()
            recorder.tag = job.name
            t0 = time.perf_counter()
            rc = cli.main([str(CLIP), "--job-dir", str(job), "--keep"])
            cli_walls.append(time.perf_counter() - t0)
            launches, decoder_launches = count.median, count.decoders
            recorder.tag = None
            walls.append(result.seconds)
            if rc != 0:
                raise AssertionError(f"cli exited {rc}")
            if launches != MEDIAN_LAUNCHES_PER_SONG:
                raise AssertionError(f"median kernel launched {launches} times in one CLI song, expected {MEDIAN_LAUNCHES_PER_SONG}")
            if decoder_launches != DECODER_LAUNCHES_PER_SONG:
                raise AssertionError(f"decoder kernels launched {decoder_launches} times in one CLI song, expected {DECODER_LAUNCHES_PER_SONG}")
            out = read_out(job)
            bt = out["beat_times.json"]
            if out["result.json"]["transcription_error"] is not None:
                raise AssertionError(f"stage errors on the card: {out['result.json']['transcription_error']}")
            if (bt["stem_source"], bt["beat_source"], bt["demucs_error"], bt["errors"]) != ("guitar", "drums", None, []):
                raise AssertionError(f"unexpected beat_times.json: stem {bt['stem_source']}, beats {bt['beat_source']}, "
                                     f"demucs_error {bt['demucs_error']}, errors {bt['errors']}")
            if set(out) != OUT_ARTIFACTS or {p.name for p in (job / "work").iterdir()} != WORK_ARTIFACTS:
                raise AssertionError(f"artifact set: out {sorted(out)}, work {sorted(p.name for p in (job / 'work').iterdir())}")
            prof = out["profile.json"]
            if set(STAGES) - set(prof):
                raise AssertionError(f"profile.json lacks stages {sorted(set(STAGES) - set(prof))}")
            tail_s = sum(prof[k] for k in STAGES[STAGES.index("beats") :])
            print(f"cli song {run} ({'cold' if run == 0 else 'warm'}): run_pipeline {walls[-1]:.3f} s, cli main {cli_walls[-1]:.3f} s, "
                  f"host tail (beats to export) {tail_s:.4f} s, median launches {launches}, decoder launches {decoder_launches}, "
                  f"stages (s) {json.dumps(prof)} [{card}]")
        res = result.last
    if res.key_signature is None or not res.chords or res.score is None or res.transcription_backend != "guitar_hybrid":
        raise AssertionError(f"incomplete result: {res.to_json()[:400]}")
    print(f"cli on {CLIP.name}: run_pipeline cold {walls[0]:.3f} s, warm {walls[1]:.3f} s / {walls[2]:.3f} s; "
          f"key {res.key_signature.name}, {res.time_signature}, tempo {res.tempo_bpm:.2f}, {len(res.chords)} chords, "
          f"{len(res.score.measures)} measures, artifacts {sorted(OUT_ARTIFACTS)} + work {sorted(WORK_ARTIFACTS)} [{card}]")

    # the song's device-to-host copies (a trace short of one is taken again: see retrace)
    traced, dtoh = traced_copies(lambda: cli.main([str(CLIP), "--job-dir", str(JOBS / "cli_profiled"), "--keep"]), "the song")
    if traced["dtoh"] != dtoh:
        raise AssertionError(f"{traced['dtoh']} device-to-host copies in one run_pipeline, expected {dtoh}")

    # the host tail on the CPU, on the card's own host features and native audio
    job = JOBS / "cli2"
    y, sr, (x_nat, sr_nat) = decode_for_analysis(CLIP, pipeline.ANALYSIS_SR)
    cpu_job = JOBS / "tail_cpu" / job.name
    tail = pipeline._pipeline_tail(
        feats=feats.last, y_harm=np.asarray(feats.last["y_harm"], dtype=np.float32)[: len(y)], true_len=len(y), sr=sr,
        out=cpu_job / "out", job_id=job.name, stages={}, errors=[], stem_source="guitar",
        beat_act_from_feats=True, y_native=(peak_normalize(x_nat), sr_nat), settings=Settings(),
    )
    card_out, cpu_out = read_out(job), read_out(cpu_job)
    if json.loads(tail.to_json()) != card_out.pop("result.json"):
        raise AssertionError("the CPU tail's JobResult differs from the card's result.json")
    names = sorted(set(card_out) - {"profile.json"})
    if sorted(set(cpu_out) - {"profile.json"}) != names:
        raise AssertionError(f"CPU tail artifacts {sorted(cpu_out)} against the card's {sorted(card_out)}")
    for name in names:
        a, b = (job / "out" / name).read_bytes(), (cpu_job / "out" / name).read_bytes()
        if a != b:
            raise AssertionError(f"{name}: the CPU tail on the card's features writes other bytes")
    print(f"cpu _pipeline_tail on the card's host features: {len(names)} artifacts byte-equal ({', '.join(names)})")
    song_shapes = {name: [r.shape for r in recorder.launches if (r.kernel, r.tag) == (name, job.name)] for name in DECODERS}
    return {"walls": walls, "launches": launches, "decoder_launches": decoder_launches, "decoder_shapes": song_shapes,
            "traced": traced, "out": read_out(job)}


def compare_pipelines(card_out: dict, cpu_res, cpu_out: dict) -> None:
    """The card CLI's artifacts against a CPU run_pipeline's (each on its own
    stems): beat times, chords, key and time signature equal (confidences and
    the key score within FLOAT_TOL); the notes' agreement printed."""
    for field in ("raw_beat_times", "beat_times", "downbeat_times", "time_signature", "tempo_bpm", "offset"):
        if cpu_out["beat_times.json"][field] != card_out["beat_times.json"][field]:
            raise AssertionError(f"beat_times.json {field} differs between the card and the CPU run_pipeline")
    card_chords, cpu_chords = card_out["chords.json"], cpu_out["chords.json"]
    if [(c["start"], c["end"], c["label"]) for c in cpu_chords] != [(c["start"], c["end"], c["label"]) for c in card_chords]:
        raise AssertionError(f"chords differ between the card and the CPU run_pipeline: {card_chords} / {cpu_chords}")
    np.testing.assert_allclose([c["confidence"] for c in cpu_chords], [c["confidence"] for c in card_chords], err_msg="chord confidence", **FLOAT_TOL)
    card_key, cpu_key = dict(card_out["result.json"]["key_signature"]), cpu_res.key_signature.to_dict()
    np.testing.assert_allclose(cpu_key.pop("score"), card_key.pop("score"), err_msg="key score", **FLOAT_TOL)
    if (cpu_key, cpu_res.time_signature) != (card_key, card_out["result.json"]["time_signature"]):
        raise AssertionError(f"key or time signature differs: card {card_key}, cpu {cpu_key}")
    card_rows = card_out["note_events.csv"].decode().splitlines()[1:]
    cpu_rows = cpu_out["note_events.csv"].decode().splitlines()[1:]
    same = sum(a.split(",")[:3] == b.split(",")[:3] for a, b in zip(card_rows, cpu_rows))
    print(f"end to end, card CLI vs cpu run_pipeline: beat times, {len(card_chords)} chords, key {card_key['name']} and "
          f"{cpu_res.time_signature} equal; note events {len(card_rows)} on the card, {len(cpu_rows)} on the cpu, "
          f"{same} rows with equal start, end and pitch")


def separation_phase(y_pad: np.ndarray, sr: int) -> dict:
    """htdemucs on the 30 s bucket: card against CPU stems; time, device ops, peak memory, FLOP rate."""
    from torch.profiler import ProfilerActivity, profile
    from torch.utils.flop_counter import FlopCounterMode

    from audiotabs_tpu_torch.config import Settings
    from audiotabs_tpu_torch.models import htdemucs

    s = Settings()
    cfg = htdemucs.program_config(htdemucs.load_params(), s.DEMUCS_MODEL, s.stem_priority())
    n_windows = s.DEMUCS_SHIFTS * len(htdemucs._segment_windows(2 * len(y_pad), cfg["seg"], cfg["stride"]))
    y = torch.from_numpy(y_pad).cuda()

    def sep():
        return htdemucs.separate_stems_device(y, sr, model_name=s.DEMUCS_MODEL, shifts=s.DEMUCS_SHIFTS, bf16=s.DEMUCS_BF16)

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    stems = sep()
    torch.cuda.synchronize()
    cold_s = time.perf_counter() - t0
    ms = cuda_ms(sep, reps=5, warmup=1)
    warm_s = wall_s(sep)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    sep()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    with FlopCounterMode(display=False) as counter:
        sep()
    flops = counter.get_total_flops()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        sep()
        torch.cuda.synchronize()
    events = device_events(prof)
    ops = len(events)
    dev_ms = busy_ms(events)
    print_top("separation top", events, 12)

    t0 = time.perf_counter()
    cpu = htdemucs.separate_stems_device(torch.from_numpy(y_pad), sr, model_name=s.DEMUCS_MODEL, shifts=s.DEMUCS_SHIFTS, bf16=s.DEMUCS_BF16)
    cpu_s = time.perf_counter() - t0
    errs = {}
    for name, a in cpu.items():
        b = stems[name].cpu()
        if b.shape != a.shape or not torch.isfinite(b).all():
            raise AssertionError(f"stem {name}: shape {tuple(b.shape)} or non-finite values")
        errs[name] = float((b - a).abs().max() / a.abs().max())
    row = dict(windows=n_windows, seg=cfg["seg"], cold_s=cold_s, ms=ms, wall_ms=warm_s * 1e3, device_busy_ms=dev_ms, device_ops=ops,
               peak_mb=peak / 2**20, peak_over_resident_mb=(peak - before) / 2**20, flops=flops,
               flops_per_window=flops / n_windows, tflops_per_s=flops / (ms * 1e-3) / 1e12,
               fp32_bound_ms=flops / FP32_FLOPS_PER_S * 1e3, cpu_s=cpu_s, stem_err_over_peak=errs)
    print("separation", json.dumps(row))
    print(f"separation ({n_windows} windows of {cfg['seg']}): {ms:.2f} ms by events, {warm_s * 1e3:.2f} ms wall, "
          f"{dev_ms:.2f} ms of device busy time in {ops} device ops, peak {peak / 2**30:.3f} GiB, "
          f"{flops / 1e9:.1f} GFLOP of convolutions and matrix products ({row['tflops_per_s']:.2f} TFLOP/s; "
          f"float32 floor {row['fp32_bound_ms']:.2f} ms at 67 TFLOP/s), cold {cold_s:.2f} s, cpu {cpu_s:.2f} s")
    print(f"separation cuda vs cpu, largest error over the stem's peak: {errs} (tolerance {STEM_TOL})")
    bad = {k: v for k, v in errs.items() if not v < STEM_TOL}
    if bad:
        raise AssertionError(f"card stems differ from the CPU stems beyond {STEM_TOL}: {bad}")
    return row


def run_profiled(run) -> dict:
    """One call under torch.profiler: its wall, device busy ms and share,
    device ops, median launches and device-to-host copies."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        time.sleep(TRACE_TAIL_S)
    events = device_events(prof)
    if not events:
        raise AssertionError("no device time in the trace")
    busy = busy_ms(events)
    return dict(wall_ms=wall * 1e3, busy_ms=busy, busy_share=busy / 1e3 / wall, device_ops=len(events),
                median_launches=sum("median_" in name for name, _, _ in events),
                dtoh=sum(name.startswith("Memcpy DtoH") for name, _, _ in events))


def retrace(trace, short, what: str, tries: int = 3):
    """``trace()`` again, up to ``tries`` times in all, while ``short(result)``.

    A trace can lack device records: the same chunk's trace held 120,817
    device ops in one run and 120,604, without its one device-to-host copy,
    in another (NVIDIA H100 80GB HBM3, 700 W). A dropped record can only
    lower a count, so only a count below the expected one is traced again,
    and every retry is printed; the caller still checks the last result
    exactly."""
    for attempt in range(tries):
        out = trace()
        if not short(out) or attempt == tries - 1:
            return out
        print(f"profiler: {what} (trace {attempt + 1} of at most {tries}); tracing again")


def profiled_counts(run, launches: int, dtoh: int) -> dict:
    """run_profiled, traced again while the trace holds fewer median launches
    or device-to-host copies than expected (see retrace)."""
    return retrace(lambda: run_profiled(run), lambda p: p["median_launches"] < launches or p["dtoh"] < dtoh,
                   f"fewer than {launches} median launches or {dtoh} device-to-host copies in the trace")


def note_rows(out: dict) -> collections.Counter:
    """A job's notes as a multiset of (start, end, pitch)."""
    return collections.Counter(tuple(r.split(",")[:3]) for r in out["note_events.csv"].decode().splitlines()[1:])


class CountChunks(Capture):
    """``batch_runner._analyse_chunk`` with each chunk's median launches
    (``launches``) and decoder launches (``decoders``) counted from just
    before it to just after it."""

    def __init__(self):
        from audiotabs_tpu_torch.runtime import batch_runner

        super().__init__(batch_runner, "_analyse_chunk")
        self.launches, self.decoders = [], []

    def __enter__(self):
        super().__enter__()
        keep = getattr(self.module, self.name)

        def counted(*args, **kwargs):
            count = Launches()
            out = keep(*args, **kwargs)
            self.launches.append(count.median)
            self.decoders.append(count.decoders)
            return out

        setattr(self.module, self.name, counted)
        return self


def counted_batch(paths: list, out_root: Path, s, chunks: tuple) -> tuple:
    """One ``transcribe_batch`` on the card, counted by chunk: it must run in
    chunks of ``chunks`` songs, each with 8 median launches and a CLI song's
    decoder launches (one DBN, one CRF, one salience envelope, two onset and
    one banded Viterbi launch, whatever the chunk's size). Returns the
    results, the captures of its separations and transfers, the counts and
    its wall seconds."""
    from audiotabs_tpu_torch.models import htdemucs
    from audiotabs_tpu_torch.runtime import batch_runner

    with CountChunks() as counts, Capture(htdemucs, "separate_program") as sep, \
            Capture(batch_runner, "features_to_host") as host:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        results = batch_runner.transcribe_batch(paths, out_root, device="cuda", settings=s)
        wall = time.perf_counter() - t0
    if counts.launches != [MEDIAN_LAUNCHES_PER_SONG] * len(chunks):
        raise AssertionError(f"median launches per chunk {counts.launches}, expected {MEDIAN_LAUNCHES_PER_SONG} in each of {len(chunks)}")
    if [args[1].shape[0] for args, _, _ in sep.calls] != list(chunks):
        raise AssertionError(f"chunks of {[args[1].shape[0] for args, _, _ in sep.calls]} songs, expected {list(chunks)}")
    expect = [DECODER_LAUNCHES_PER_SONG] * len(chunks)
    if counts.decoders != expect:
        raise AssertionError(f"decoder launches per chunk {counts.decoders}, expected {expect}")
    return results, sep, host, counts, wall


def check_batch_jobs(results: list, paths: list, out_root: Path) -> None:
    """Every song's result.json and artifact set, the guitar stem, no stage error."""
    for r, clip in zip(results, paths):
        job = out_root / "jobs" / clip.stem
        out = read_out(job)
        if r.job_id != clip.stem or r.transcription_error is not None or out["result.json"]["transcription_error"] is not None:
            raise AssertionError(f"batch song {clip.name}: job {r.job_id}, errors {r.transcription_error}")
        missing = OUT_ARTIFACTS - set(out) - {"content_segments.json", "strum_onsets.json", "chosen_shapes.json"}
        if missing or out["beat_times.json"]["stem_source"] != "guitar" or out["beat_times.json"]["errors"]:
            raise AssertionError(f"batch song {clip.name}: missing {sorted(missing)}, beat_times {out['beat_times.json']['stem_source']} {out['beat_times.json']['errors']}")
    print(f"batch: every one of the {len(results)} songs has result.json and the artifact set, stem guitar, no stage error")


def check_batch_rows(sep: Capture, host: Capture, true_lens: list, sr: int, s) -> None:
    """A counted batch's rows: each row's stems against a 1-D separation of
    the row, its fused outputs against ``fused_analysis`` on the row and
    the batch's stems."""
    from audiotabs_tpu_torch.models import htdemucs
    from audiotabs_tpu_torch.runtime import pipeline
    from audiotabs_tpu_torch.runtime.fused import fused_analysis

    cfg = htdemucs.program_config(htdemucs.load_params(), s.DEMUCS_MODEL, s.stem_priority())
    worst_stem, a = 0.0, 0
    with torch.inference_mode(), torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        for (args, kwargs, stems), (_, _, feats) in zip(sep.calls, host.calls):
            model, y = args[0], args[1]
            for j in range(y.shape[0]):
                one = htdemucs.separate_program(model, y[j], *args[2:], **kwargs)
                err = ((stems[j] - one).abs().amax(dim=-1) / one.abs().amax(dim=-1)).max().item()
                worst_stem = max(worst_stem, err)
                if not err < STEM_TOL:
                    raise AssertionError(f"batch row {a + j}: stems differ from a 1-D separation by {err} of the peak")
                row = pipeline.features_to_host(fused_analysis(
                    stems[j, cfg["stem_idx"]].contiguous(), sr, chord_backend="deep", true_len=true_lens[a + j],
                    y_beat=stems[j, cfg["drums_idx"]].contiguous(), y_mix=y[j]))
                compare_with_cpu(f"batch row {a + j} vs fused_analysis", row, {k: v[j] for k, v in feats.items()}, quiet=True)
            a += y.shape[0]
    print(f"batch rows: stems within {worst_stem:.3g} of the peak of a 1-D separation (tolerance {STEM_TOL}); fused outputs of "
          f"every one of the {a} rows against fused_analysis on the row: discrete equal, floats within {FLOAT_TOL}, f16 within {F16_TOL}")


def batch_phase(card: str) -> dict:
    """The batch runner under the shipped settings: the six held-out clips
    (all in the 30 s bucket) in chunks of 4 and 2 songs, cold then warm;
    8 median launches and 1 device-to-host copy per chunk; each row's stems
    against a 1-D separation of the row and its fused outputs against
    ``fused_analysis`` on the row and the batch's stems; every song's
    artifact set. Then the six songs one at a time through ``run_pipeline``
    (printed against the batch, not checked)."""
    from audiotabs_tpu_torch.config import Settings
    from audiotabs_tpu_torch.runtime import batch_runner, pipeline

    s = Settings.from_env()  # the shipped settings, as the CLI reads them
    if s.BATCH_SONGS_PER_DEVICE != CHUNK_SONGS[0] or len(HELDOUT) != sum(CHUNK_SONGS):
        raise AssertionError(f"expected {len(HELDOUT)} clips in chunks of {s.BATCH_SONGS_PER_DEVICE}")
    shutil.rmtree(BATCH_JOBS, ignore_errors=True)
    walls = []
    for run in range(2):
        results, sep, host, counts, wall = counted_batch(HELDOUT, BATCH_JOBS, s, CHUNK_SONGS)
        walls.append(wall)
        print(f"batch run {run} ({'cold' if run == 0 else 'warm'}): {len(HELDOUT)} songs in {walls[-1]:.3f} s, "
              f"median launches per chunk {counts.launches}, decoder launches per chunk {counts.decoders} [{card}]")
    batch, true_lens, sr = batch_runner._load_and_bucket(HELDOUT, s.PAD_SECONDS_BUCKET)
    audio_s = sum(true_lens) / sr
    print(f"batch: {audio_s:.2f} s of audio in {walls[1]:.3f} s warm = {audio_s / walls[1]:.3f} audio-s per wall s (cold {walls[0]:.3f} s) [{card}]")
    template_chunk = template_chunk_check(s, batch, true_lens, sr, card)
    check_batch_jobs(results, HELDOUT, BATCH_JOBS)
    warm_rows = {k: np.concatenate([res[k] for _, _, res in host.calls]) for k in host.calls[0][2]}
    check_batch_rows(sep, host, true_lens, sr, s)

    # profiler: the whole warm batch, then one chunk of each size alone
    prof = profiled_counts(lambda: batch_runner.transcribe_batch(HELDOUT, BATCH_JOBS / "profiled", device="cuda", settings=s),
                           MEDIAN_LAUNCHES_PER_SONG * len(CHUNK_SONGS), len(CHUNK_SONGS))
    print(f"batch profile: {json.dumps(prof)} [{card}]")
    if (prof["median_launches"], prof["dtoh"]) != (MEDIAN_LAUNCHES_PER_SONG * len(CHUNK_SONGS), len(CHUNK_SONGS)):
        raise AssertionError(f"profiled batch: {prof['median_launches']} median launches and {prof['dtoh']} device-to-host copies")
    chunks = {}
    for b, rows in zip(CHUNK_SONGS, (batch[:4], batch[4:])):
        lens = true_lens[:4] if b == 4 else true_lens[4:]
        chunks[b] = profiled_counts(lambda: batch_runner.batched_fused_analysis(rows, sr, lens, device="cuda", settings=s), MEDIAN_LAUNCHES_PER_SONG, 1)
        print(f"chunk of {b} songs alone: {json.dumps(chunks[b])} [{card}]")
        if (chunks[b]["median_launches"], chunks[b]["dtoh"]) != (MEDIAN_LAUNCHES_PER_SONG, 1):
            raise AssertionError(f"chunk of {b}: {chunks[b]['median_launches']} median launches, {chunks[b]['dtoh']} device-to-host copies")

    # the same six songs one at a time (warm), printed against the batch
    single = []
    for clip, r in zip(HELDOUT, results):
        job = BATCH_JOBS / "single" / clip.stem
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = pipeline.run_pipeline(job, clip, device="cuda", settings=s)
        single.append(time.perf_counter() - t0)
        b_out, s_out = read_out(BATCH_JOBS / "jobs" / clip.stem), read_out(job)
        chords = [(c["start"], c["end"], c["label"]) for c in b_out["chords.json"]], [(c["start"], c["end"], c["label"]) for c in s_out["chords.json"]]
        beats = b_out["beat_times.json"]["raw_beat_times"], s_out["beat_times.json"]["raw_beat_times"]
        b_notes, s_notes = note_rows(b_out), note_rows(s_out)
        same_notes = sum((b_notes & s_notes).values())
        print(f"batch vs single {clip.name}: key {r.key_signature.name if r.key_signature else None} / {res.key_signature.name if res.key_signature else None}, "
              f"chords equal {chords[0] == chords[1]} ({len(chords[0])} / {len(chords[1])}), raw beats equal {beats[0] == beats[1]} "
              f"({len(beats[0])} / {len(beats[1])}, largest shift {max((abs(x - y) for x, y in zip(*beats)), default=0.0):.4f} s), "
              f"notes {sum(b_notes.values())} / {sum(s_notes.values())}, {same_notes} in both (start, end, pitch); single run_pipeline {single[-1]:.3f} s")
    print(f"one at a time: {sum(single):.3f} s for the six songs ({audio_s / sum(single):.3f} audio-s per wall s), batch {walls[1]:.3f} s [{card}]")
    return {"walls": walls, "launches_per_chunk": counts.launches, "decoder_launches_per_chunk": counts.decoders,
            "profile": prof, "chunks": chunks, "single_s": single, "rows": warm_rows, "template_chunk_decoders": template_chunk}


def template_chunk_check(s, batch: np.ndarray, true_lens, sr: int, card: str) -> dict:
    """The template chord backend on the batch's first chunk (the first 4
    held-out clips): the decoder launches of a template song for the whole
    chunk (one constant-switch launch), and each row's outputs against
    ``fused_analysis`` of the row alone on the stems the chunk separated
    (the chord path equal, the rest as ``compare_with_cpu``)."""
    from audiotabs_tpu_torch.models import htdemucs
    from audiotabs_tpu_torch.runtime import batch_runner, pipeline
    from audiotabs_tpu_torch.runtime.fused import fused_analysis

    b = CHUNK_SONGS[0]
    template = dataclasses.replace(s, CHORD_DETECTION_BACKEND="template")
    with Capture(htdemucs, "separate_program") as sep:
        count = Launches()
        got = batch_runner.batched_fused_analysis(batch[:b], sr, true_lens[:b], device="cuda", settings=template)
        launches = count.expect(TEMPLATE, f"a template chunk of {b} songs")
    if got["chord_path"].shape[0] != b or not np.isfinite(got["chord_conf"]).all():
        raise AssertionError(f"template chunk: chord path {got['chord_path'].shape}, confidences finite {np.isfinite(got['chord_conf']).all()}")
    cfg = htdemucs.program_config(htdemucs.load_params(), s.DEMUCS_MODEL, s.stem_priority())
    (args, _, stems), = sep.calls
    with torch.inference_mode(), torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        for j in range(b):
            row = pipeline.features_to_host(fused_analysis(
                stems[j, cfg["stem_idx"]].contiguous(), sr, chord_backend="template", true_len=true_lens[j],
                y_beat=stems[j, cfg["drums_idx"]].contiguous(), y_mix=args[1][j]))
            if not np.array_equal(row["chord_path"], got["chord_path"][j]):
                raise AssertionError(f"template chunk row {j}: chord path differs from fused_analysis of the row")
            compare_with_cpu(f"template chunk row {j} vs fused_analysis", row, {k: v[j] for k, v in got.items()}, quiet=True)
    print(f"template chunk ({b} clips, CHORD_DETECTION_BACKEND=template): decoder launches {launches}; every row's chord path "
          f"equal to fused_analysis of the row, the rest discrete equal and floats within {FLOAT_TOL} [{card}]")
    return launches


ONSET_DENSITY = 1  # the column of content_metrics that holds a window's onsets per second


def onset_knife_edge(w: int, start: int, stems: tuple, sr: int) -> str:
    """Where the onset picker of content window ``w`` decides otherwise on
    the card and on the CPU: each device's envelope of the window (from its
    own stem) against its threshold, mean + delta, at the frames whose
    candidacy differs, and the smaller margin."""
    from audiotabs_tpu_torch.ops.onset import _sliding_reduce, onset_strength

    cand, parts = [], []
    for stem in stems:
        n = stem.shape[-1]
        idx = torch.arange(start, start + 3 * sr, device=stem.device)
        window = torch.where(idx < n, stem[idx.clamp(max=n - 1)], torch.zeros((), device=stem.device))
        env = onset_strength(window[None], sr, hop=512, n_fft=1024)[0]
        thr = _sliding_reduce(env, 3, 5, "mean") + 0.5
        cand.append(((env >= _sliding_reduce(env, 3, 3, "max")) & (env >= thr)).cpu())
        parts.append((env.cpu(), thr.cpu()))
    frames = torch.nonzero(cand[0] != cand[1]).flatten().tolist()
    out = []
    for f in frames:
        (e0, t0), (e1, t1) = (tuple(float(x[f]) for x in pair) for pair in parts)
        out.append(f"frame {f}: card envelope {e0:.6f} against its threshold {t0:.6f}, cpu {e1:.6f} against {t1:.6f}, "
                   f"margin {min(abs(e0 - t0), abs(e1 - t1)):.3g}")
    return "; ".join(out) or "no frame's candidacy differs"


def compare_long_with_cpu(what: str, cpu: dict, card: dict, stems: tuple, sr: int) -> list:
    """``compare_with_cpu`` on the 180 s song, with one knife edge allowed:
    the onset density of one content window (``content_metrics[w, 1]``) one
    onset apart, a knife edge (an envelope within float32 noise of its
    threshold), printed with its margin; every other element of every
    output at its tolerance, the discrete outputs exactly. Returns the knife
    edges that showed."""
    rest_cpu, rest_card = dict(cpu), dict(card)
    a, b = rest_cpu.pop("content_metrics"), rest_card.pop("content_metrics")
    compare_with_cpu(what, rest_cpu, rest_card)
    bad = ~np.isclose(b, a, **FLOAT_TOL)
    one_onset = 1.0 / 3.0  # one onset over a 3 s window
    edges = [(int(w), float(b[w, ONSET_DENSITY]), float(a[w, ONSET_DENSITY])) for w in np.nonzero(bad[:, ONSET_DENSITY])[0]]
    if bad.sum() != len(edges) or len(edges) > 1 or any(abs(abs(x - y) - one_onset) > 1e-5 for _, x, y in edges):
        np.testing.assert_allclose(b, a, err_msg=f"{what} content_metrics", **FLOAT_TOL)
    for w, x, y in edges:
        start = int(card["content_starts"][w])
        print(f"{what} knife edge: content_metrics[{w}, {ONSET_DENSITY}] (the onset density of the window at sample {start}) "
              f"{x:.4f} on the card, {y:.4f} on the cpu; {onset_knife_edge(w, start, stems, sr)}")
    print(f"{what} content_metrics: every other element within {FLOAT_TOL}; knife edges {len(edges)}")
    return edges


def long_phase(recorder: RecordLaunches, card: str) -> dict:
    """The JAX package's north-star song, bench.py's 180 s synthetic mix
    (``make_test_audio``; ``long_song_wall_s``), under the shipped settings:

    - the CLI (``cli.main``, which calls ``run_pipeline``) cold, then warm as
      bench.py runs it (up to 3 warm-ups, then the minimum of 3), every
      kernel's launches counted from just before each song: 8 median
      launches and a CLI song's decoder launches, the guitar stem and the drums as beat
      source, no stage error, the 30 s CLI song's artifact set, a
      result.json whose score has measures, every stage in profile.json;
    - one warm song traced (device ops, busy share, 1 device-to-host copy,
      2 with the strum envelope pass) and its peak device memory;
    - ``run_analysis`` with its stems kept: the CPU ``fused_analysis`` on
      those stems against the card's outputs (``compare_long_with_cpu``),
      beat times equal; the card's stems against the CPU separation of the
      same mix within STEM_TOL of each stem's peak; warm ``run_analysis``
      and separation times;
    - the CPU ``run_pipeline_from_features`` on the card CLI's features: the
      card's beat times, chords, key and time signature.

    ``recorder`` records the median launches (held and timed at the new
    shapes afterwards)."""
    from audiotabs_tpu_torch.config import Settings
    from audiotabs_tpu_torch.io.wav import decode_for_analysis, peak_normalize, write_wav
    from audiotabs_tpu_torch.models import htdemucs
    from audiotabs_tpu_torch.runtime import cli, pipeline
    from audiotabs_tpu_torch.runtime.fused import fused_analysis

    shutil.rmtree(LONG_JOBS, ignore_errors=True)
    LONG_JOBS.mkdir(parents=True)
    sr = pipeline.ANALYSIS_SR
    wav = LONG_JOBS / "song180.wav"
    write_wav(wav, make_test_audio(float(LONG_SONG_S), sr), sr)
    shipped = Settings.from_env()

    with Capture(pipeline, "features_to_host") as feats, Capture(pipeline, "run_pipeline") as result:
        def run(tag: str, rec: RecordLaunches | None = None) -> float:
            job = LONG_JOBS / tag
            count = Launches()
            with rec or contextlib.nullcontext():
                rc = cli.main([str(wav), "--job-dir", str(job), "--keep"])
            launches, decoders = count.median, count.decoders
            if rc != 0:
                raise AssertionError(f"cli exited {rc} on the {LONG_SONG_S} s song")
            if launches != MEDIAN_LAUNCHES_PER_SONG or decoders != DECODER_LAUNCHES_PER_SONG:
                raise AssertionError(f"the {LONG_SONG_S} s song launched the median kernel {launches} times and the decoders {decoders}")
            out = read_out(job)
            bt, res = out["beat_times.json"], out["result.json"]
            if res["transcription_error"] is not None or (bt["stem_source"], bt["beat_source"], bt["demucs_error"], bt["errors"]) != ("guitar", "drums", None, []):
                raise AssertionError(f"the {LONG_SONG_S} s song did not run cleanly: error {res['transcription_error']}, stem {bt['stem_source']}, "
                                     f"beats {bt['beat_source']}, demucs_error {bt['demucs_error']}, errors {bt['errors']}")
            if set(out) != OUT_ARTIFACTS or {p.name for p in (job / "work").iterdir()} != WORK_ARTIFACTS:
                raise AssertionError(f"the {LONG_SONG_S} s song's artifact set: out {sorted(out)}, work {sorted(p.name for p in (job / 'work').iterdir())}")
            if not (res["score"] or {}).get("measures") or set(STAGES) - set(out["profile.json"]):
                raise AssertionError(f"the {LONG_SONG_S} s song: no score, or profile.json lacks {sorted(set(STAGES) - set(out['profile.json']))}")
            print(f"long song {tag}: run_pipeline {result.seconds:.3f} s, median launches {launches}, decoder launches {decoders}, "
                  f"{len(bt['beat_times'])} beats, {len(res['chords'])} chords, {len(res['score']['measures'])} measures, "
                  f"stages (s) {json.dumps(out['profile.json'])} [{card}]")
            return result.seconds

        cold = run("cold", recorder)
        prev, warmups = cold, [cold]
        for i in range(1, 3):  # bench.py's long song: its first run is the cold one
            cur = run(f"warmup{i}")
            warmups.append(cur)
            if cur < prev * 1.2 and cur < LONG_SONG_S / 5:
                break
            prev = cur
        walls = [run(f"run{i}") for i in range(3)]
        card_feats = feats.last  # the last run's, beside its artifacts
    card_out = read_out(LONG_JOBS / "run2")
    stages = read_out(LONG_JOBS / f"run{int(np.argmin(walls))}")["profile.json"]
    print(f"long song: run_pipeline cold {cold:.3f} s, warm-ups {[round(w, 3) for w in warmups[1:]]}, warm {[round(w, 3) for w in walls]} s, "
          f"minimum {min(walls):.3f} s ({LONG_SONG_S / min(walls):.2f} audio-s per wall s); stages of the fastest (s) "
          f"{json.dumps(stages)} [{card}]")

    # one warm song traced, and its peak device memory
    traced, dtoh = traced_copies(lambda: cli.main([str(wav), "--job-dir", str(LONG_JOBS / "profiled"), "--keep"]), "the long song")
    if traced["dtoh"] != dtoh:
        raise AssertionError(f"{traced['dtoh']} device-to-host copies in the {LONG_SONG_S} s song, expected {dtoh}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    cli.main([str(wav), "--job-dir", str(LONG_JOBS / "peak"), "--keep"])
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    print(f"long song: peak device memory {peak / 2**30:.3f} GiB ({(peak - resident) / 2**30:.3f} GiB above the resident "
          f"{resident / 2**30:.3f} GiB), traced {traced['device_ops']} device ops, busy share {traced['busy_share']} [{card}]")

    # run_analysis with its stems kept; the CPU on those stems
    with Capture(pipeline, "separate_stems_device") as sep:
        card_feats_a, beats, info = pipeline.run_analysis(wav, device="cuda", settings=shipped)
    stems = sep.last
    if info != {"stem_source": "guitar", "errors": []}:
        raise AssertionError(f"run_analysis of the {LONG_SONG_S} s song did not separate cleanly: {info}")
    check_outputs(card_feats_a, beats, FUSED_DEEP_KEYS | {"beat_from_drums"})
    y, _, _ = decode_for_analysis(wav, sr)
    y = peak_normalize(y)
    y_pad = np.ascontiguousarray(pipeline._pad_to_bucket(y, sr, shipped.PAD_SECONDS_BUCKET), dtype=np.float32)
    t0 = time.perf_counter()
    with torch.inference_mode():
        cpu_feats = pipeline.features_to_host(fused_analysis(
            stems["guitar"].cpu(), sr, chord_backend="deep", true_len=len(y), y_beat=stems["drums"].cpu(), y_mix=torch.from_numpy(y_pad)))
    cpu_fused_s = time.perf_counter() - t0
    edges = compare_long_with_cpu("long song, card stems, cuda vs cpu fused", cpu_feats, card_feats_a, (stems["guitar"], stems["guitar"].cpu()), sr)
    t100 = int(len(y) / sr * 100)
    cpu_beats = pipeline.beats_from_decoded(cpu_feats["dbn_phases"][:t100], cpu_feats["dbn_intervals"][:t100],
                                            np.asarray(cpu_feats["beat_activation"], dtype=np.float32)[:t100], fps=100)
    if not np.array_equal(cpu_beats, beats):
        raise AssertionError(f"beat times of the {LONG_SONG_S} s song differ between cuda and cpu on the card's stems")
    print(f"long song, card stems, cuda vs cpu fused ({cpu_fused_s:.1f} s on the cpu): discrete outputs, beat_from_drums and the "
          f"{beats.size} beat times equal; floats within {FLOAT_TOL}, f16 outputs within {F16_TOL}; chord frames "
          f"{card_feats_a['crf_path'].shape}, content windows {card_feats_a['content_starts'].shape}")
    analysis_s = wall_s(lambda: pipeline.run_analysis(wav, device="cuda", settings=shipped))

    # separation: the card's stems against the CPU's on the same padded mix, and its time
    mix = torch.from_numpy(y_pad)
    mix_card = mix.cuda()
    kwargs = dict(model_name=shipped.DEMUCS_MODEL, shifts=shipped.DEMUCS_SHIFTS, bf16=shipped.DEMUCS_BF16)
    sep_ms = cuda_ms(lambda: htdemucs.separate_stems_device(mix_card, sr, **kwargs), reps=3, warmup=1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    htdemucs.separate_stems_device(mix_card, sr, **kwargs)
    torch.cuda.synchronize()
    sep_peak = torch.cuda.max_memory_allocated() - before
    t0 = time.perf_counter()
    cpu_stems = htdemucs.separate_stems_device(mix, sr, **kwargs)
    cpu_sep_s = time.perf_counter() - t0
    errs = {name: float((stems[name].cpu() - a).abs().max() / a.abs().max()) for name, a in cpu_stems.items()}
    print(f"long song separation: {sep_ms:.2f} ms by events, {sep_peak / 2**30:.3f} GiB above the resident memory; cpu {cpu_sep_s:.1f} s; "
          f"largest error over the stem's peak {errs} (tolerance {STEM_TOL}) [{card}]")
    bad = {k: v for k, v in errs.items() if not v < STEM_TOL}
    if bad:
        raise AssertionError(f"the {LONG_SONG_S} s song's card stems differ from the CPU stems beyond {STEM_TOL}: {bad}")
    print(f"long song: run_analysis warm {analysis_s:.3f} s (separation {sep_ms:.2f} ms of it) [{card}]")

    # the CPU tail on the card CLI's own features
    cpu_job = LONG_JOBS / "tail_cpu" / "jobs" / "song180"
    t0 = time.perf_counter()
    cpu_res = pipeline.run_pipeline_from_features(card_feats, len(y), sr, cpu_job, stem_source="guitar", settings=shipped, device="cpu")
    print(f"cpu run_pipeline_from_features on the card's features: {time.perf_counter() - t0:.3f} s, errors {cpu_res.transcription_error}")
    compare_pipelines(card_out, cpu_res, read_out(cpu_job))
    return {"cold_s": cold, "warmups_s": warmups[1:], "walls_s": walls, "stages": stages, "traced": traced,
            "peak_gib": peak / 2**30, "run_analysis_s": analysis_s, "separation_ms": sep_ms, "separation_peak_gib": sep_peak / 2**30,
            "cpu_separation_s": cpu_sep_s, "stem_err_over_peak": errs, "knife_edges": edges,
            "launches": MEDIAN_LAUNCHES_PER_SONG, "decoder_launches": dict(DECODER_LAUNCHES_PER_SONG)}


def batch8_phase(card: str) -> dict:
    """bench.py's batch: eight 30 s songs (``make_test_audio(30)`` plus
    0.01 N(0, 1) noise from ``default_rng(7)``) through ``transcribe_batch``
    under the shipped settings, two chunks of ``BATCH_SONGS_PER_DEVICE``,
    cold then three warm runs counted by chunk (``counted_batch``); one warm
    run traced: 8 median launches and 1 device-to-host copy per chunk; each
    row against ``fused_analysis`` on the row and the batch's stems; every
    song's artifact set. Prints audio-s per wall s of the fastest warm run."""
    from audiotabs_tpu_torch.config import Settings
    from audiotabs_tpu_torch.io.wav import write_wav
    from audiotabs_tpu_torch.runtime import batch_runner

    s = Settings.from_env()
    sr, seconds = 22050, 30.0
    chunks = (s.BATCH_SONGS_PER_DEVICE,) * (BATCH8_SONGS // s.BATCH_SONGS_PER_DEVICE)
    if sum(chunks) != BATCH8_SONGS:
        raise AssertionError(f"{BATCH8_SONGS} songs do not fall into chunks of {s.BATCH_SONGS_PER_DEVICE}")
    shutil.rmtree(BATCH8_JOBS, ignore_errors=True)
    BATCH8_JOBS.mkdir(parents=True)
    audio = make_test_audio(seconds, sr)
    rng = np.random.default_rng(7)
    paths = []
    for i in range(BATCH8_SONGS):
        y = audio + 0.01 * rng.standard_normal(len(audio)).astype(np.float32)
        paths.append(BATCH8_JOBS / f"b{i}.wav")
        write_wav(paths[-1], y.astype(np.float32), sr)
    walls = []
    for run in range(4):
        results, sep, host, counts, wall = counted_batch(paths, BATCH8_JOBS / f"run{run}", s, chunks)
        walls.append(wall)
        print(f"batch of {BATCH8_SONGS} run {run} ({'cold' if run == 0 else 'warm'}): {wall:.3f} s, median launches per chunk "
              f"{counts.launches}, decoder launches per chunk {counts.decoders} [{card}]")
    check_batch_jobs(results, paths, BATCH8_JOBS / "run3")
    _, true_lens, _ = batch_runner._load_and_bucket(paths, s.PAD_SECONDS_BUCKET)
    check_batch_rows(sep, host, true_lens, sr, s)
    launches, dtoh = MEDIAN_LAUNCHES_PER_SONG * len(chunks), len(chunks)
    prof = profiled_counts(lambda: batch_runner.transcribe_batch(paths, BATCH8_JOBS / "profiled", device="cuda", settings=s), launches, dtoh)
    if (prof["median_launches"], prof["dtoh"]) != (launches, dtoh):
        raise AssertionError(f"profiled batch of {BATCH8_SONGS}: {prof['median_launches']} median launches and {prof['dtoh']} device-to-host copies")
    audio_s = BATCH8_SONGS * seconds
    print(f"batch of {BATCH8_SONGS}: {audio_s:.0f} s of audio, warm {[round(w, 3) for w in walls[1:]]} s, fastest {min(walls[1:]):.3f} s = "
          f"{audio_s / min(walls[1:]):.3f} audio-s per wall s (cold {walls[0]:.3f} s); traced: {json.dumps(prof)} [{card}]")
    return {"walls_s": walls, "audio_s_per_s": audio_s / min(walls[1:]), "launches_per_chunk": counts.launches,
            "decoder_launches_per_chunk": counts.decoders, "profile": prof}


MESH_JOBS = REPO / "build" / "chip_smoke_mesh"  # git-ignored


def mesh_phase(card: str, batch: dict) -> dict:
    """The device mesh (parallel/), on the machine's one card:

    a. ``transcribe_batch`` over the six held-out clips with
       ``mesh=default_mesh()`` (a 1-D "data" mesh over every card): 8 median
       launches per chunk of 4 and 2 songs; every row's discrete outputs and
       beat times equal the batch phase's (``device=``, no mesh), its floats
       within FLOAT_TOL; the same artifact set.
    b. ``batched_fused_analysis`` over a 2-way "data" mesh of
       [cuda:0, cuda:0] at B = 6 and B = 5 (one zero pad row): each chunk's
       rows split 2 ways, 8 launches per device shard, counted from the code;
       each row equal to the 1-way mesh's row; the kernel held exactly at the
       new shard shapes.
    c. The shipped htdemucs_6s checkpoint at full width with its weights
       sharded over a ("data", "model") mesh of shape (1, 2) on
       [cuda:0, cuda:0]: the distributed parameters and the bytes each shard
       holds, the separation of the 30 s bucket's windows against the
       unsharded module within STEM_TOL, both warm times by CUDA events."""
    from audiotabs_tpu_torch.config import Settings
    from audiotabs_tpu_torch.models import htdemucs
    from audiotabs_tpu_torch.parallel import default_mesh, make_mesh
    from audiotabs_tpu_torch.parallel.model_axis import shard_params_model_axis, sharded_count, sharded_parameters
    from audiotabs_tpu_torch.runtime import batch_runner

    s = Settings.from_env()  # the shipped settings, as the CLI reads them
    per_shard = []

    class CountShards(Capture):
        def __enter__(self):
            super().__enter__()
            keep = getattr(self.module, self.name)

            def counted(*args, **kwargs):
                count = Launches()
                out = keep(*args, **kwargs)
                per_shard.append((args[0].shape[0], count.median))
                # one DBN, one CRF, one salience envelope, two onset and one banded Viterbi launch per shard
                count.expect(DECODER_LAUNCHES_PER_SONG, f"a device shard of {args[0].shape[0]} rows")
                return out

            setattr(self.module, self.name, counted)
            return self

    # a. the default mesh: every card on "data"
    mesh = default_mesh(s)
    print(f"default mesh: {mesh}")
    if mesh.shape != {"data": torch.cuda.device_count()}:
        raise AssertionError(f"default mesh {mesh.shape}, expected every card on one data axis")
    shutil.rmtree(MESH_JOBS, ignore_errors=True)
    with CountShards(batch_runner, "_analyse_chunk"), Capture(batch_runner, "features_to_host") as host:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        results = batch_runner.transcribe_batch(HELDOUT, MESH_JOBS, mesh=mesh, settings=s)
        wall = time.perf_counter() - t0
    if per_shard != [(b, MEDIAN_LAUNCHES_PER_SONG) for b in CHUNK_SONGS]:
        raise AssertionError(f"default mesh: (songs, median launches) per device shard {per_shard}, expected {MEDIAN_LAUNCHES_PER_SONG} for each of {list(CHUNK_SONGS)}")
    rows = {k: np.concatenate([res[k] for _, _, res in host.calls]) for k in host.calls[0][2]}
    for i, (clip, r) in enumerate(zip(HELDOUT, results)):
        compare_with_cpu(f"mesh row {i} vs batch row", {k: v[i] for k, v in batch["rows"].items()}, {k: v[i] for k, v in rows.items()}, quiet=True)
        m_out, b_out = read_out(MESH_JOBS / "jobs" / clip.stem), read_out(BATCH_JOBS / "jobs" / clip.stem)
        if set(m_out) != set(b_out) or r.transcription_error is not None:
            raise AssertionError(f"mesh song {clip.name}: artifacts {sorted(set(m_out) ^ set(b_out))} differ, error {r.transcription_error}")
        for key in ("raw_beat_times", "beat_times"):
            if m_out["beat_times.json"][key] != b_out["beat_times.json"][key]:
                raise AssertionError(f"mesh song {clip.name}: {key} differ from the batch phase's")
    launches_default = [n for _, n in per_shard]
    print(f"mesh a (default mesh {mesh.shape}): {len(HELDOUT)} songs in {wall:.3f} s, (songs, median launches) per device shard {per_shard}, "
          f"decoder launches per shard {DECODER_LAUNCHES_PER_SONG}; "
          f"every row's discrete outputs and beat times equal the batch phase's, floats within {FLOAT_TOL}; the same artifact set [{card}]")

    # b. a 2-way data mesh on the one card: rows split 2 ways, one zero pad row at B = 5
    two = make_mesh((2,), ("data",), devices=[torch.device("cuda:0")] * 2)
    data, true_lens, sr = batch_runner._load_and_bucket(HELDOUT, s.PAD_SECONDS_BUCKET)
    two_way = {}
    with RecordLaunches(["median_filter"], keep=2) as recorder:
        for b in (6, 5):
            n_dev = two.shape["data"]
            rows_padded = b + (-b) % n_dev
            chunk = n_dev * s.BATCH_SONGS_PER_DEVICE
            shards = [min(chunk, rows_padded - a) // n_dev for a in range(0, rows_padded, chunk) for _ in range(n_dev)]
            expect = [(n, MEDIAN_LAUNCHES_PER_SONG) for n in shards]  # counted from the code: 8 per device shard
            per_shard.clear()
            with CountShards(batch_runner, "_analyse_chunk"):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                got = batch_runner.batched_fused_analysis(data[:b], sr, true_lens[:b], mesh=two, settings=s)
                wall = time.perf_counter() - t0
            if per_shard != expect:
                raise AssertionError(f"2-way mesh, B = {b}: (rows, median launches) per device shard {per_shard}, expected {expect}")
            if got["crf_path"].shape[0] != b:
                raise AssertionError(f"2-way mesh, B = {b}: {got['crf_path'].shape[0]} rows came back")
            for i in range(b):
                compare_with_cpu(f"2-way row {i} vs 1-way row", {k: v[i] for k, v in rows.items()}, {k: v[i] for k, v in got.items()}, quiet=True)
            two_way[b] = sum(n for _, n in per_shard)
            print(f"mesh b (2-way data mesh on one card, B = {b}, {(-b) % n_dev} pad rows): {wall:.3f} s, (rows, median launches) per device shard "
                  f"{per_shard}; every row equal to the 1-way mesh's (discrete equal, floats within {FLOAT_TOL}) [{card}]")
    shapes = new_shape_kernel_check(recorder)

    # c. the model axis: the shipped checkpoint's weights over "model" = 2
    params = htdemucs.load_params()
    cfg = htdemucs.program_config(params, s.DEMUCS_MODEL, s.stem_priority())
    whole = htdemucs.load_model(torch.device("cuda:0"))  # the unsharded module the other phases ran
    net = htdemucs.HTDemucs.from_params(params).cuda()
    total_bytes = sum(p.numel() * p.element_size() for p in net.parameters())
    shard_params_model_axis(net, make_mesh((1, 2), ("data", "model"), devices=[torch.device("cuda:0")] * 2))
    shards = sharded_parameters(net)
    shard_bytes = [sum(parts[j].numel() * parts[j].element_size() for parts in shards.values()) for j in range(2)]
    replicated = sum(p.numel() * p.element_size() for n, p in net.named_parameters() if "parametrizations" not in n)
    y = torch.from_numpy(np.ascontiguousarray(batch_runner._load_and_bucket([CLIP], 30.0)[0][0])).cuda()

    def sep(model):
        return htdemucs.separate_program(model, y, sr, cfg["seg"], cfg["stride"], s.DEMUCS_SHIFTS)

    with torch.inference_mode(), torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        ref, out = sep(whole), sep(net)
        err = float(((out - ref).abs().amax(dim=-1) / ref.abs().amax(dim=-1)).max())
        ms_whole = cuda_ms(lambda: sep(whole), reps=5, warmup=1)
        ms_sharded = cuda_ms(lambda: sep(net), reps=5, warmup=1)
    model_axis = dict(sharded_count=sharded_count(net), parameters=len(list(whole.parameters())), bytes_total=total_bytes,
                      bytes_per_shard=shard_bytes, bytes_replicated=replicated, stem_err_over_peak=err,
                      ms_unsharded=ms_whole, ms_sharded=ms_sharded)
    print("mesh c", json.dumps(model_axis), f"[{card}]")
    print(f"mesh c (htdemucs_6s over a (1, 2) data x model mesh on one card): {model_axis['sharded_count']} of {model_axis['parameters']} parameters "
          f"distributed, {shard_bytes[0]} + {shard_bytes[1]} bytes in the two shards and {replicated} replicated of {total_bytes}; "
          f"stems within {err:.3g} of the peak of the unsharded module's (tolerance {STEM_TOL}); separation of the 30 s bucket "
          f"{ms_sharded:.2f} ms sharded against {ms_whole:.2f} ms by events [{card}]")
    if model_axis["sharded_count"] < 20 or not err < STEM_TOL or not torch.isfinite(out).all():
        raise AssertionError(f"model axis: {model_axis['sharded_count']} distributed parameters, stems within {err} of the unsharded module's")
    return {"launches_default_mesh_per_chunk": launches_default, "launches_two_way": two_way, "new_shapes": shapes, "model_axis": model_axis}


def serving_phase(card: str, cli_result: dict) -> list[int]:
    """The job API on the card: an inline job and a queued job drained by
    the worker, each with every kernel's launches counted from just before
    it (8 median launches each, the decoders' as a CLI song's); every
    artifact route; the inline result.json against the CLI's. Returns the two jobs' median launch counts."""
    import http.client
    import socket

    from audiotabs_tpu_torch.config import Settings
    from audiotabs_tpu_torch.runtime import server, worker

    def request(method, path, body=None, headers=None):
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
        conn.request(method, path, body=body, headers=headers or {})
        resp = conn.getresponse()
        data = resp.read()
        conn.close()
        return resp.status, resp.getheader("Content-Type"), data

    shutil.rmtree(SERVE_DATA, ignore_errors=True)
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    httpd = server.serve(port, str(SERVE_DATA), background=True, device="cuda", settings=Settings.from_env())
    try:
        status, _, data = request("GET", "/health")
        print(f"serve /health: {status} {data.decode()}")
        if status != 200:
            raise AssertionError("health check failed")
        clip, queued = CLIP, REPO / "tests" / "data" / "heldout" / "heldout_picked_melody.wav"
        launches = []
        count = Launches()
        t0 = time.perf_counter()
        status, _, data = request("POST", "/v1/jobs?inline=1", body=clip.read_bytes(), headers={"X-Filename": clip.name})
        inline_s = time.perf_counter() - t0
        launches.append(count.median)
        count.expect(DECODER_LAUNCHES_PER_SONG, "the inline job")
        inline = json.loads(data)
        if status != 200 or inline["status"] != "done":
            raise AssertionError(f"inline job: {status} {inline}")
        status, _, data = request("POST", "/v1/jobs", body=queued.read_bytes(), headers={"X-Filename": queued.name})
        job = json.loads(data)
        if status != 200 or job["status"] != "queued":
            raise AssertionError(f"queued job: {status} {job}")
        count = Launches()
        t0 = time.perf_counter()
        if worker.main(["--data-dir", str(SERVE_DATA), "--once"]) != 0:
            raise AssertionError("worker exited non-zero")
        worker_s = time.perf_counter() - t0
        launches.append(count.median)
        count.expect(DECODER_LAUNCHES_PER_SONG, "the queued job")
        if launches != [MEDIAN_LAUNCHES_PER_SONG] * 2:
            raise AssertionError(f"median launches of the inline and the queued job {launches}, expected {MEDIAN_LAUNCHES_PER_SONG} each")
        deadline = time.perf_counter() + 60
        while True:
            info = json.loads(request("GET", f"/v1/jobs/{job['job_id']}")[2])
            if info["status"] in ("done", "error") or time.perf_counter() > deadline:
                break
            time.sleep(0.2)
        if info["status"] != "done":
            raise AssertionError(f"queued job ended {info}")
        for job_id in (inline["job_id"], job["job_id"]):
            for route, mime in ROUTES.items():
                status, ctype, data = request("GET", f"/v1/jobs/{job_id}/{route}")
                if status != 200 or ctype != mime or not data:
                    raise AssertionError(f"GET {route} of {job_id}: {status} {ctype} {len(data)} bytes")
        got = json.loads(request("GET", f"/v1/jobs/{inline['job_id']}/result.json")[2])
        ref = dict(cli_result)
        if got.pop("job_id") != inline["job_id"] or got != {k: v for k, v in ref.items() if k != "job_id"}:
            raise AssertionError("the inline job's result.json differs from the CLI's")
        status_q = json.loads(request("GET", f"/v1/jobs/{job['job_id']}/result.json")[2])
        if status_q["transcription_error"] is not None or got["transcription_error"] is not None:
            raise AssertionError(f"serving stage errors: {got['transcription_error']} / {status_q['transcription_error']}")
    finally:
        httpd.shutdown()
        httpd.server_close()
    print(f"serve: inline job ({clip.name}) {inline_s:.3f} s, worker {worker_s:.3f} s for one queued job ({queued.name}), "
          f"median launches {launches}, decoder launches {DECODER_LAUNCHES_PER_SONG} each; {len(ROUTES)} artifact routes of both jobs 200 with their content types; "
          f"inline result.json equals the CLI's [{card}]")
    return launches


def encode_mp3(path: Path, pcm: np.ndarray, sr: int, kbps: int = 192) -> bool:
    """Mono MP3 through the system libmp3lame (False when it is absent)."""
    import ctypes

    try:
        lame = ctypes.CDLL("libmp3lame.so.0")
    except OSError:
        return False
    lame.lame_init.restype = ctypes.c_void_p
    gfp = ctypes.c_void_p(lame.lame_init())
    lame.lame_set_in_samplerate(gfp, sr)
    lame.lame_set_num_channels(gfp, 1)
    lame.lame_set_mode(gfp, 3)  # MONO
    lame.lame_set_brate(gfp, kbps)
    if lame.lame_init_params(gfp) < 0:
        raise RuntimeError("lame_init_params failed")
    s16 = np.ascontiguousarray(np.clip(pcm, -1, 1) * 32767, dtype=np.int16)
    out = (ctypes.c_ubyte * (len(s16) * 2 + 16384))()
    lame.lame_encode_buffer.argtypes = [ctypes.c_void_p, np.ctypeslib.ndpointer(np.int16), ctypes.c_void_p, ctypes.c_int,
                                        ctypes.POINTER(ctypes.c_ubyte), ctypes.c_int]
    n = lame.lame_encode_buffer(gfp, s16, None, len(s16), out, len(out))
    tail = (ctypes.c_ubyte * 16384)()
    m = lame.lame_encode_flush(gfp, tail, len(tail))
    lame.lame_close(gfp)
    if n < 0 or m < 0:
        raise RuntimeError(f"lame_encode failed ({n}, {m})")
    path.write_bytes(bytes(out[:n]) + bytes(tail[:m]))
    return True


def decode_phase(card: str, cli_result: dict) -> dict:
    """Which decoders the machine has; the native resampler against scipy's;
    uploads of other formats as inline jobs on the card (see step 10)."""
    import ctypes
    import http.client
    import socket

    from scipy.signal import resample_poly

    from audiotabs_tpu_torch.config import Settings
    from audiotabs_tpu_torch.io import avdecode, mp3, native
    from audiotabs_tpu_torch.io.wav import load_wav
    from audiotabs_tpu_torch.runtime import server

    lib = native.get_lib()
    try:
        ctypes.CDLL("libmp3lame.so.0")
        lame = True
    except OSError:
        lame = False
    have = {"native": None if lib is None else Path(lib._name).name, "libmpg123": mp3.mp3_available(), "libmp3lame": lame,
            "libavformat_headers": avdecode.headers_present(), "ffmpeg_shim": avdecode.av_available(), "ffmpeg_binary": shutil.which("ffmpeg")}
    print(f"decoders: {json.dumps(have)}")
    if lib is None:
        raise AssertionError("the native library did not build from native/audiotabs_native.cpp")
    if have["libavformat_headers"] and not have["ffmpeg_shim"]:
        raise AssertionError("the libavformat headers are present but the FFmpeg shim did not build")
    x, sr = load_wav(CLIP)
    diffs = {}
    for sr_out in (22050, 48000):
        ref = resample_poly(x.astype(np.float64), *(np.array([sr_out, sr]) // np.gcd(sr_out, sr))).astype(np.float32)
        got = native.resample_native(x, sr, sr_out)
        n = min(len(ref), len(got))
        diffs[f"{sr}->{sr_out}"] = float(np.abs(got[:n] - ref[:n]).max())
    print(f"native resampler against scipy.signal.resample_poly, largest difference: {diffs}")

    data = REPO / "build" / "chip_smoke_decode"
    shutil.rmtree(data, ignore_errors=True)
    data.mkdir(parents=True)
    uploads = {"clip.upload": CLIP.read_bytes()}  # a WAV under another suffix: found by its header
    if have["libmpg123"] and lame:
        mp3_path = data / f"{CLIP.stem}.mp3"
        if not encode_mp3(mp3_path, x, sr):
            raise AssertionError("libmp3lame loaded but did not encode")
        decoded, sr_mp3 = mp3.decode_mp3(mp3_path)
        print(f"mp3: {mp3_path.stat().st_size} bytes at 192 kb/s, decoded {len(decoded) / sr_mp3:.3f} s at {sr_mp3} Hz")
        uploads[mp3_path.name] = mp3_path.read_bytes()
    else:
        print(f"decode: the MP3 job is skipped: libmpg123 {have['libmpg123']}, libmp3lame {lame}")
    uploads["noise.ogg"] = np.random.default_rng(3).integers(1, 200, 65536, dtype=np.uint8).tobytes()  # no decoder takes it

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    httpd = server.serve(port, str(data), background=True, device="cuda", settings=Settings.from_env())
    jobs = {}
    try:
        for name, body in uploads.items():
            count = Launches()
            t0 = time.perf_counter()
            conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
            conn.request("POST", "/v1/jobs?inline=1", body=body, headers={"X-Filename": name})
            resp = conn.getresponse()
            info = json.loads(resp.read())
            conn.close()
            jobs[name] = (resp.status, info, time.perf_counter() - t0, count.median)
            # an upload no decoder takes launches nothing; the others as a CLI song
            count.expect(dict.fromkeys(DECODERS, 0) if name == "noise.ogg" else DECODER_LAUNCHES_PER_SONG, f"upload {name}")
    finally:
        httpd.shutdown()
        httpd.server_close()
    out = {"decoders": have, "resampler_vs_scipy": diffs}
    for name, (status, info, wall, launches) in jobs.items():
        job = data / "jobs" / info["job_id"]
        suffix = Path(name).suffix
        if not (job / "input" / f"upload{suffix}").exists():
            raise AssertionError(f"job {name} did not keep its upload's suffix")
        if name == "noise.ogg":
            err = json.loads((job / "status.json").read_text()).get("error")
            want = "cannot decode upload.ogg: not a WAV and no ffmpeg binary available"
            if status != 200 or info["status"] != "error" or launches != 0 or (have["ffmpeg_binary"] is None and err != want):
                raise AssertionError(f"undecodable upload: {status} {info}, {launches} median launches, error {err!r}")
            print(f"undecodable upload {name}: job error {err!r}, no median or decoder launch")
            continue
        result = json.loads((job / "out" / "result.json").read_text()) if info["status"] == "done" else {}
        if status != 200 or info["status"] != "done" or launches != MEDIAN_LAUNCHES_PER_SONG or result["transcription_error"] is not None:
            raise AssertionError(f"inline job {name}: {status} {info}, {launches} median launches, errors {result.get('transcription_error')}")
        labels = [c["label"] for c in result["chords"]], [c["label"] for c in cli_result["chords"]]
        if result["key_signature"]["name"] != cli_result["key_signature"]["name"] or labels[0] != labels[1]:
            raise AssertionError(f"job {name} against the WAV job: key {result['key_signature']['name']} / "
                                 f"{cli_result['key_signature']['name']}, chords {labels[0]} / {labels[1]}")
        decode_s = json.loads((job / "out" / "profile.json").read_text())["decode"]
        print(f"inline job {name}: {wall:.3f} s (decode stage {decode_s} s), median launches {launches}, decoder launches "
              f"{DECODER_LAUNCHES_PER_SONG}, key "
              f"{result['key_signature']['name']} and {len(labels[0])} chord labels as the WAV job's [{card}]")
        out[name] = {"wall_s": wall, "decode_s": decode_s, "launches": launches}
    return out


def _same_within(a, b, path: str = "") -> None:
    """JSON values equal, floats within FLOAT_TOL."""
    if isinstance(a, float) and isinstance(b, float):
        np.testing.assert_allclose(b, a, err_msg=path, **FLOAT_TOL)
    elif isinstance(a, dict) and isinstance(b, dict):
        if list(a) != list(b):
            raise AssertionError(f"{path}: keys {list(a)} / {list(b)}")
        for k in a:
            _same_within(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, list) and isinstance(b, list):
        if len(a) != len(b):
            raise AssertionError(f"{path}: {len(a)} / {len(b)} items")
        for i, (x, y) in enumerate(zip(a, b)):
            _same_within(x, y, f"{path}[{i}]")
    elif a != b:
        raise AssertionError(f"{path}: {a!r} / {b!r}")


# the template backend decodes without the CRF: one constant-switch decode in
# the fused analysis (majmin7's emissions), whose path the tail takes for
# majmin7; for another vocabulary the tail builds its chroma again
# (chords/extract.py::chroma_features: a second salience envelope) and decodes
# its own emissions (a second constant-switch decode)
TEMPLATE = DECODER_LAUNCHES_PER_SONG | {"dense_viterbi": 0, "constant_switch_viterbi": 1}
TEMPLATE_OTHER_VOCAB = TEMPLATE | {"salience_envelope": 2, "constant_switch_viterbi": 2}
# the tail's own pass over 4 s windows adds an onset and a pYIN launch
OWN_WINDOWS = DECODER_LAUNCHES_PER_SONG | {"onset_wait": 3, "banded_viterbi": 2}
# a failed fused analysis: each stage recomputes its device work, as the fused
# analysis would but for the salience (transcription and chords run the
# Basic Pitch CNN and DeepChroma, whose weights load)
DEGRADED = DECODER_LAUNCHES_PER_SONG | {"salience_envelope": 0}
SETTINGS_CASES = {
    # name: (environment, median launches per song, decoder launches per song,
    #        whether the tail decodes again on the device)
    "notes": ({"TRANSCRIPTION_MODE": "notes"}, MEDIAN_LAUNCHES_PER_SONG, DECODER_LAUNCHES_PER_SONG, False),
    "template": ({"CHORD_DETECTION_BACKEND": "template", "CHORD_VOCAB": "majmin7"}, MEDIAN_LAUNCHES_PER_SONG, TEMPLATE, False),
    "template_majmin7plus": ({"CHORD_DETECTION_BACKEND": "template", "CHORD_VOCAB": "majmin7plus"}, MEDIAN_LAUNCHES_PER_SONG,
                             TEMPLATE_OTHER_VOCAB, True),
    "content": ({"CONTENT_ANALYSIS_WINDOW_SEC": "4.0", "CONTENT_ANALYSIS_HOP_SEC": "2.0"}, MEDIAN_LAUNCHES_PER_SONG + 2, OWN_WINDOWS, True),
}


def settings_phase(card: str, name: str, recorder: RecordLaunches) -> dict:
    """One setting through the CLI on the card; the CPU tail on its host features."""
    import os

    from audiotabs_tpu_torch.config import Settings
    from audiotabs_tpu_torch.io.wav import decode_for_analysis, peak_normalize
    from audiotabs_tpu_torch.runtime import cli, pipeline

    env, expect, expect_dec, redecodes = SETTINGS_CASES[name]
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        settings = Settings.from_env()
        job = JOBS / name
        shutil.rmtree(job, ignore_errors=True)
        n_before = len(recorder.launches)
        with Capture(pipeline, "features_to_host") as feats, Capture(pipeline, "run_pipeline") as result:
            count = Launches()
            rc = cli.main([str(CLIP), "--job-dir", str(job), "--keep"])
            launches, decoders = count.median, count.decoders
        sites = recorder.sites()[n_before:]
        traced = None
        if name == "template":  # the constant-switch Viterbi's path: one warm song traced
            traced = profile_busy_share(lambda: cli.main([str(CLIP), "--job-dir", str(JOBS / "template_profiled"), "--keep"]))
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    out = read_out(job)
    errors = out["result.json"]["transcription_error"]
    if rc != 0 or errors is not None or launches != expect or decoders != expect_dec:
        raise AssertionError(f"{name}: cli rc {rc}, errors {errors}, {launches} median launches (expected {expect}), "
                             f"decoder launches {decoders} (expected {expect_dec})")
    prof = out["profile.json"]
    print(f"{name} ({env}): run_pipeline {result.seconds:.3f} s, median launches {launches} at {sites}, decoder launches {decoders}, backend "
          f"{out['result.json']['transcription_backend']}, {len(out['result.json']['chords'])} chords "
          f"{[c['label'] for c in out['result.json']['chords']][:8]}, stages (s) {json.dumps(prof)} [{card}]")

    y, sr, (x_nat, sr_nat) = decode_for_analysis(CLIP, pipeline.ANALYSIS_SR)
    cpu_job = JOBS / "tail_cpu" / name
    shutil.rmtree(cpu_job, ignore_errors=True)
    tail = pipeline._pipeline_tail(
        feats=feats.last, y_harm=np.asarray(feats.last["y_harm"], dtype=np.float32)[: len(y)], true_len=len(y), sr=sr,
        out=cpu_job / "out", job_id=job.name, stages={}, errors=[], stem_source="guitar",
        beat_act_from_feats=True, y_native=(peak_normalize(x_nat), sr_nat), settings=settings, device="cpu",
    )
    card_out, cpu_out = read_out(job), read_out(cpu_job)
    card_result = card_out.pop("result.json")
    names = sorted(set(card_out) - {"profile.json"})
    if sorted(set(cpu_out) - {"profile.json"}) != names:
        raise AssertionError(f"{name}: CPU tail artifacts {sorted(cpu_out)} against the card's {sorted(card_out)}")
    within = []
    for art in ["result.json", *names]:
        a = card_result if art == "result.json" else card_out[art]
        b = json.loads(tail.to_json()) if art == "result.json" else cpu_out[art]
        if a == b:
            continue
        if not redecodes or not art.endswith(".json"):
            raise AssertionError(f"{name}: {art} of the CPU tail on the card's features differs")
        _same_within(a, b, art)
        within.append(art)
    print(f"{name}: cpu _pipeline_tail on the card's host features: {len(names) + 1 - len(within)} artifacts equal, "
          f"{within} equal but for floats within {FLOAT_TOL} (the tail decodes again, on the CPU)")
    return {"launches": launches, "decoder_launches": decoders, "sites": sites, "wall_s": result.seconds, "profile": prof, "traced": traced}


def degraded_phase(card: str, recorder: RecordLaunches) -> dict:
    """fused_analysis made to raise: run_pipeline on the card recomputes every
    stage; against a CPU run of the same path on the card's stems."""
    from audiotabs_tpu_torch.config import Settings
    from audiotabs_tpu_torch.runtime import pipeline

    def fail(*args, **kwargs):
        raise RuntimeError("forced")

    shipped = Settings()
    runs = []
    real = pipeline.fused_analysis
    pipeline.fused_analysis = fail
    try:
        for run in range(2):
            job = JOBS / f"degraded{run}"
            shutil.rmtree(job, ignore_errors=True)
            n_before = len(recorder.launches)
            with Capture(pipeline, "separate_stems_device") as sep:
                count = Launches()
                t0 = time.perf_counter()
                res = pipeline.run_pipeline(job, CLIP, device="cuda", settings=shipped)
                wall = time.perf_counter() - t0
                launches = count.median
                # each stage decodes again on the card: the decoder launches of a fused song but the salience's
                decoders = count.expect(DEGRADED, f"degraded run {run}")
            out = read_out(job)
            sites = recorder.sites()[n_before:]
            print(f"degraded run {run} ({'cold' if run == 0 else 'warm'}): {wall:.3f} s, median launches {launches} at {sites}, decoder launches {decoders}, "
                  f"errors {out['beat_times.json']['errors']}, stages (s) {json.dumps(out['profile.json'])} [{card}]")
            if out["beat_times.json"]["errors"] != ["analysis: forced"] or res.transcription_error != "analysis: forced":
                raise AssertionError(f"degraded path errors: {out['beat_times.json']['errors']}")
            if launches != 6:
                raise AssertionError(f"degraded path: {launches} median launches, expected 6")
            # result.json is the caller's to write (cli.py, jobs.py); the calibration cache sits in work/
            if set(out) != OUT_ARTIFACTS - {"result.json"} or {p.name for p in (job / "work").iterdir()} != WORK_ARTIFACTS | {"audio_analysis"}:
                raise AssertionError(f"degraded artifact set: out {sorted(out)}, work {sorted(p.name for p in (job / 'work').iterdir())}")
            runs.append({"wall_s": wall, "launches": launches, "decoder_launches": decoders, "sites": sites, "profile": out["profile.json"]})
        stems = {k: v.cpu() for k, v in sep.last.items()}

        # the same path on the CPU, on the card's stems
        separate = pipeline.separate_stems_device
        pipeline.separate_stems_device = lambda *args, **kwargs: stems
        try:
            shutil.rmtree(JOBS / "degraded_cpu", ignore_errors=True)
            t0 = time.perf_counter()
            cpu_res = pipeline.run_pipeline(JOBS / "degraded_cpu", CLIP, device="cpu", settings=shipped)
            cpu_s = time.perf_counter() - t0
        finally:
            pipeline.separate_stems_device = separate
    finally:
        pipeline.fused_analysis = real
    card_out, cpu_out = read_out(JOBS / "degraded1"), read_out(JOBS / "degraded_cpu")
    card_out["result.json"] = json.loads(res.to_json())
    if cpu_res.transcription_error != "analysis: forced":
        raise AssertionError(f"CPU degraded run errors: {cpu_res.transcription_error}")
    compare_pipelines(card_out, cpu_res, cpu_out)
    print(f"degraded: card against the CPU run of the same path on the card's stems ({cpu_s:.3f} s on the CPU): beat times, chords, "
          f"key and time signature equal; key {res.key_signature.name}, {res.time_signature}, {len(res.chords)} chords [{card}]")
    return {"runs": runs, "cpu_s": cpu_s}


def new_shape_kernel_check(recorder: RecordLaunches) -> dict:
    """The kernel exactly against its plain version on every launch the new
    paths made (the launched inputs), and at each new shape on random and
    tie-heavy inputs; each new shape timed as check_kernel times the others."""
    from audiotabs_tpu_torch.ops import median

    rng = np.random.default_rng(1)
    known = {(shape, win, axis) for shape, win, axis in MAIN_PATH_MEDIANS}
    err = 0.0
    for (shape, win, axis), launch in zip(recorder.sites(), recorder.launches):
        if launch.args is None:
            continue
        got, ref = median.median_filter(*launch.args), median.median_filter_plain(*launch.args)
        if not torch.equal(got, ref):
            raise AssertionError(f"median kernel differs from the plain version on a launched input {shape} win {win} axis {axis}")
    rows = {}
    # a [1, F, T] launch of the fused analysis is the [F, T] main-path shape
    sites = {(shape[1:] if len(shape) == 3 and shape[0] == 1 else shape, win, axis) for shape, win, axis in recorder.sites()}
    for shape, win, axis in sorted(sites - known):
        x_np = np.abs(rng.standard_normal(shape)).astype(np.float32)
        err = max(err, check_exact(median, x_np, win, axis), check_exact(median, tie_heavy(rng, shape), win, axis))
        x = torch.from_numpy(x_np).cuda()
        row = dict(
            ms=cuda_ms(lambda: median.median_filter(x, win, axis)),
            single_ms=cuda_ms(lambda: median.median_filter(x, win, axis), spin=False),
            device_ms=device_ms(lambda: median.median_filter(x, win, axis)),
            plain_ms=cuda_ms(lambda: median.median_filter_plain(x, win, axis), reps=20),
            bound_ms=2 * x.numel() * 4 / HBM_BYTES_PER_S * 1e3,
        )
        rows[f"{'x'.join(map(str, shape))} win {win} axis {axis}"] = row
        print("median new shape", json.dumps(dict(shape=list(shape), win=win, axis=axis, **row)))
    kept = sum(1 for launch in recorder.launches if launch.args is not None)
    print(f"median exact on the {kept} kept of the {len(recorder.launches)} launched inputs of the new paths "
          f"(all of them unless the recorder keeps fewer) and at {len(rows)} new shapes (random and tie-heavy)")
    return {"max_abs_err": err, "rows": rows}




def decoder_modules() -> dict:
    return {name: importlib.import_module(mod) for name, (mod, _) in DECODERS.items()}


class Launches:
    """The kernels' launches since it was made, from the tracer's counters
    (``<kernel>_launches``, which ``_build.launch`` adds to): ``median`` and
    ``decoders`` (by kernel)."""

    def __init__(self):
        from audiotabs_tpu_torch import tracing

        self.tracing, self.start = tracing, tracing.counters()

    def of(self, name: str) -> int:
        key = f"{name}_launches"
        return self.tracing.counters().get(key, 0) - self.start.get(key, 0)

    @property
    def median(self) -> int:
        return self.of("median_filter")

    @property
    def decoders(self) -> dict[str, int]:
        return {name: self.of(name) for name in DECODERS}

    def expect(self, expect: dict, what: str) -> dict[str, int]:
        """The decoder kernels' launches, which must be ``expect``."""
        got = self.decoders
        if got != expect:
            raise AssertionError(f"{what}: decoder kernels launched {got} times, expected {expect}")
        return got


class Launch(NamedTuple):
    kernel: str
    tag: str | None  # the tag the recorder's caller set
    shape: tuple  # the shape of the op's first argument
    scalars: tuple  # the op's arguments that are not tensors
    args: tuple | None  # a copy of the op's arguments, or None


class RecordLaunches:
    """Records every launch of the kernels ``kernels`` made while it is
    entered (``launches``), with a copy of the op's arguments for the first
    ``keep`` launches at each (kernel, shape, scalars), every launch's where
    ``keep`` is None. It wraps the port's two seams of a hand kernel:
    ``_build.plain_or_kernel``, which every op calls with its arguments, and
    ``_build.launch``, which names the kernel."""

    def __init__(self, kernels, keep: int | None = None):
        self.kernels, self.keep, self.tag = set(kernels), keep, None
        self.launches: list[Launch] = []
        self._op = threading.local()

    def __enter__(self):
        from audiotabs_tpu_torch import _build

        self._build, self._saved = _build, (_build.plain_or_kernel, _build.launch)
        dispatch, launch = self._saved

        def on_op(op, plain, kernel, *args):
            self._op.args = args
            return dispatch(op, plain, kernel, *args)

        def on_launch(name, *rest, **kwargs):
            if name in self.kernels:
                args = self._op.args
                shape, scalars = tuple(args[0].shape), tuple(a for a in args if not isinstance(a, torch.Tensor))
                kept = sum(1 for r in self.launches if (r.kernel, r.shape, r.scalars) == (name, shape, scalars) and r.args is not None)
                copy = None
                if self.keep is None or kept < self.keep:
                    copy = tuple(a.detach().clone() if isinstance(a, torch.Tensor) else a for a in args)
                self.launches.append(Launch(name, self.tag, shape, scalars, copy))
            return launch(name, *rest, **kwargs)

        _build.plain_or_kernel, _build.launch = on_op, on_launch
        return self

    def __exit__(self, *exc):
        self._build.plain_or_kernel, self._build.launch = self._saved
        return False

    def sites(self) -> list[tuple[tuple, int, int]]:
        """(shape, window, axis: -1 or -2) of each median launch."""
        return [(r.shape, r.scalars[0], -1 if r.scalars[1] == len(r.shape) - 1 else -2) for r in self.launches]


def decoder_calls(mods: dict) -> dict:
    """For each kernel: (the op that launches it, its plain version), both taking the op's arguments."""
    dbn, onset, pyin, vit, bp = (mods[n] for n in ("dbn_viterbi", "onset_wait", "banded_viterbi", "dense_viterbi", "salience_envelope"))
    return {
        "dbn_viterbi": (dbn._dbn_forward, dbn._dbn_forward_plain),
        "onset_wait": (onset._wait, onset._wait_plain),
        "banded_viterbi": (pyin._banded_viterbi, pyin._banded_viterbi_plain),
        "dense_viterbi": (vit.viterbi_log_dense, vit.viterbi_log_dense_plain),
        "salience_envelope": (bp.salience_envelope, bp.salience_envelope_plain),
        "constant_switch_viterbi": (vit.viterbi_constant_switch, vit.viterbi_constant_switch_plain),
    }


def with_nans(x: np.ndarray) -> dict:
    """"one NaN": a NaN a third of the way into the first row, in its middle
    state or bin (not the first, which a scan starts from); "NaN row": the
    last row all NaN."""
    one, row = x.copy(), x.copy()
    one[(0, x.shape[1] // 3) + tuple(n // 2 for n in x.shape[2:])] = np.nan
    row[-1] = np.nan
    return {"one NaN": one, "NaN row": row}


def nans_along_frames(x: np.ndarray) -> dict:
    """``with_nans`` on [B, rows, T] (the salience's pitches, the chord
    states): "one NaN" a third of the way into the frames of row 0, in its
    middle pitch or state; "NaN row" the last row all NaN."""
    return {k: np.ascontiguousarray(v.swapaxes(1, -1)) for k, v in with_nans(np.ascontiguousarray(x.swapaxes(1, -1))).items()}


def same(got: torch.Tensor, ref: torch.Tensor) -> bool:
    """Equal in shape, type and every value, a NaN equal to a NaN."""
    if got.shape != ref.shape or got.dtype != ref.dtype:
        return False
    if not got.is_floating_point():
        return torch.equal(got, ref)
    return bool(((got == ref) | (got.isnan() & ref.isnan())).all())


def abs_err(got: torch.Tensor, ref: torch.Tensor) -> float:
    """The largest absolute difference, 0 where both are NaN."""
    if not got.numel():
        return 0.0
    diff = (got.double() - ref.double()).abs()
    if got.is_floating_point():
        diff = torch.where(got.isnan() & ref.isnan(), torch.zeros_like(diff), diff)
    return float(diff.max())


def decoder_inputs(name: str, shape: tuple, like: tuple, rng) -> dict:
    """Random and tie-heavy inputs at ``shape`` on ``like``'s device, with its other arguments."""
    dev = like[0].device
    if name == "dbn_viterbi":
        B, T = shape
        beats = np.where(np.arange(T) % 50 < 3, 0.9, 0.05).astype(np.float32)
        ties = {"constant": np.full(shape, 0.5, np.float32), "two levels": np.broadcast_to(beats, shape).copy()}
        x = rng.random(shape).astype(np.float32)
        cases = {"random": x, **ties, **with_nans(x)}
        return {k: (torch.from_numpy(v).to(dev), *like[1:]) for k, v in cases.items()}
    if name == "onset_wait":
        runs = np.repeat(rng.random((*shape[:-1], shape[-1] // 6 + 1)) < 0.5, 6, axis=-1)[..., : shape[-1]]
        x = rng.random(shape) < 0.3
        cases = {"random": (x, like[1]), "all candidates": (np.ones(shape, bool), like[1]), "runs": (runs, like[1]),
                 "wait 0": (x, 0), "wait -1": (x, -1)}  # every candidate fires
        return {k: (torch.from_numpy(np.ascontiguousarray(v)).to(dev), w) for k, (v, w) in cases.items()}
    if name == "salience_envelope":
        x = rng.random(shape).astype(np.float32)
        loud = x * np.float32(0.02)
        loud[..., : shape[-1] // 4] += 1.0
        cases = {"random": x, "constant block maxima": np.full(shape, 0.25, np.float32), "loud then silent": loud,
                 "negative": -x - np.float32(0.5),  # negative: the padding's zeros are the last block's maximum
                 **nans_along_frames(x)}
        return {k: (torch.from_numpy(v).to(dev), *like[1:]) for k, v in cases.items()}
    if name == "constant_switch_viterbi":
        em = rng.random(shape).astype(np.float32) ** 4 + np.float32(1e-3)
        tied = em.copy()
        tied[..., ::3] = 1.0  # every third frame all states equal
        # probabilities 1, 1/2 and 1/4 with the penalty -log(1/2) as torch takes it on the card:
        # costs land exactly on the minimum plus the penalty
        levels = rng.choice(np.array([1.0, 0.5, 0.25], np.float32), size=shape)
        at_penalty = float(-torch.log(torch.tensor(0.5, device=dev)))
        em /= em.sum(1, keepdims=True)
        return {"random": (torch.from_numpy(em).to(dev), like[1]),
                "equal columns": (torch.from_numpy(tied / tied.sum(1, keepdims=True)).to(dev), like[1]),
                "at min + penalty": (torch.from_numpy(levels).to(dev), at_penalty),
                **{k: (torch.from_numpy(v).to(dev), like[1]) for k, v in nans_along_frames(em).items()}}
    if name == "banded_viterbi":
        n_bins = shape[-1]
        obs = rng.random(shape).astype(np.float32)
        obs /= obs.sum(-1, keepdims=True) * rng.uniform(1.0, 3.0, (*shape[:-1], 1))
        tied = (rng.integers(0, 3, (*shape[:-1], 1)) * np.ones(n_bins) / (3 * n_bins)).astype(np.float32)
        cases = {}
        for k, o in (("random", obs), ("equal columns", tied), *with_nans(obs).items()):
            v = np.clip(o.sum(-1), 0.0, 1.0)
            log_u = np.log(np.maximum(1.0 - v, np.float32(1e-10)) / n_bins).astype(np.float32)[..., None]
            cases[k] = (torch.from_numpy(np.log(o + np.float32(1e-10))).to(dev),
                        torch.from_numpy(log_u).to(dev).expand(*shape), *like[2:])
        return cases
    B, T, S = shape
    trans, init = like[1], like[2]
    if trans.shape[0] != S:  # another state count: the CRF's prior, staying at 0.98, a uniform start
        trans = torch.full((S, S), float(np.log(0.02 / (S - 1))), device=dev).fill_diagonal_(float(np.log(0.98)))
        init = torch.full((S,), -float(np.log(S)), device=dev)
    em = rng.random(shape).astype(np.float32) + 0.01
    tied = em.copy()
    tied[:, ::3] = 1.0  # equal emission columns every third frame
    log_em = np.log(em / em.sum(-1, keepdims=True)).astype(np.float32)
    out = {"random": (torch.from_numpy(log_em).to(dev), trans, init),
           "equal columns, uniform transitions": (torch.from_numpy(np.log(tied / tied.sum(-1, keepdims=True)).astype(np.float32)).to(dev),
                                                  torch.full_like(trans, -float(np.log(S))), init)}
    for k, e in with_nans(log_em).items():
        out[k] = (torch.from_numpy(e).to(dev), trans, init)
    return out


def decoder_work(name: str, args: tuple, mods: dict) -> tuple[int, int, int]:
    """(adds, compares, bytes) the function needs on these inputs: adds at
    the float32 add rate, compares and maxima (an argmax is one compare per
    candidate) at the min/max rate; each input read once and each output
    written once. Only valid states count: the DBN's phases p < L_i."""
    if name == "dbn_viterbi":
        act, fps, min_bpm, max_bpm = args[:4]
        B, T = act.shape
        grid = mods[name]._tempo_grid(min_bpm, max_bpm, fps)
        n, valid = len(grid), int(grid.sum())
        # each frame: n x n transition candidates (add, compare), each valid phase plus its observation
        adds, compares = B * (T - 1) * (n * n + valid), B * ((T - 1) * n * n + valid)
        return adds, compares, B * T * 4 + 2 * B * T * 4 + n * n * 4
    if name == "onset_wait":
        cand = args[0]
        return 0, 3 * cand.numel(), 2 * cand.numel()  # subtract, compare, select; a byte in, a byte out
    if name == "banded_viterbi":
        log_v, log_u, band = args[:3]
        T, n_bins = log_v.shape[-2:]
        rows = log_v.numel() // (T * n_bins)
        # candidates inside the bin range only
        cands = sum(min(2 * band, n_bins - 1 - b + band) - max(0, band - b) + 1 for b in range(n_bins))
        adds = rows * T * (2 * cands + 6 * n_bins)  # two layers of candidates; stay and switch of both; the observations
        compares = rows * T * (2 * cands + 2 * n_bins) + rows * 2 * n_bins  # their argmaxes, stay or switch; the last frame
        u_bytes = (log_u.numel() if log_u.stride(-1) else log_u.numel() // n_bins) * 4
        return adds, compares, log_v.numel() * 4 + u_bytes + rows * T * 9 + (2 * band + 1) * 4
    if name == "salience_envelope":
        sal, stride = args[:2]
        R, F, T = sal.shape
        nblk = max(1, -(-T // stride))
        # a maximum per element for the block maxima; per block the row's maximum, the two
        # scans' maxima, their maximum and the floor; the scans' multiplies at the add rate
        return R * (2 * nblk + 1), R * (F * T + 5 * nblk), sal.numel() * 4 + R * nblk * 4
    if name == "constant_switch_viterbi":
        em = args[0]
        B, S, T = em.shape
        # each frame: the minimum (S compares), the stay test (S), S + 1 adds; the last frame's minimum
        adds, compares = B * (T - 1) * (S + 1), B * ((T - 1) * 2 * S + S)
        return adds, compares, em.numel() * 4 + 2 * B * T * 4  # emissions in; path and confidences out
    em = args[0]
    B, T, S = em.shape
    adds, compares = B * ((T - 1) * (S * S + S) + S), B * ((T - 1) * S * S + S)
    return adds, compares, em.numel() * 4 + S * S * 4 + S * 4 + B * T * 4 + B * 4


def decoders_phase(mods: dict, recorder: RecordLaunches, mhz: float) -> dict:
    """Each decoder kernel bit-equal to its plain version on the card at
    every shape the paths launched it at (their own inputs, random and
    tie-heavy ones): the DBN on the 30 s bucket ([1, 3007]; batch chunks of
    4, 2 and mesh shards of 3), on the clip's true length (the failed
    analysis) and on the trainers' validation clips, the onset rule and pYIN
    on the calibration and content-window batches, the CRF on every song and
    training clip. Each shape timed: the kernel by CUDA events on inputs
    prepared once (the op's one ``_build.launch``, made again alone) and in
    the profiler, the wrapper with torch's preparation, the plain loop on the
    card; beside the bound at ``mhz``."""
    from audiotabs_tpu_torch import _build
    from audiotabs_tpu_torch.config import Settings

    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    add_rate = n_sm * FADD_PER_SM_PER_CLOCK * mhz * 1e6
    compare_rate = n_sm * FMNMX_PER_SM_PER_CLOCK * mhz * 1e6
    print(f"decoder bounds: adds at {add_rate / 1e12:.2f} T/s and compares at {compare_rate / 1e12:.2f} T/s "
          f"({n_sm} SMs x {FADD_PER_SM_PER_CLOCK} / {FMNMX_PER_SM_PER_CLOCK} per clock at {mhz} MHz), bytes at {HBM_BYTES_PER_S / 1e12} TB/s")
    rng = np.random.default_rng(2)
    calls = decoder_calls(mods)
    shapes: dict[str, dict[tuple, list]] = {name: {} for name in DECODERS}
    for r in recorder.launches:
        kept = shapes[r.kernel].setdefault(r.shape, [])
        if r.args is not None:
            kept.append(r.args)
    bucket = decoder_shapes_at(Settings().PAD_SECONDS_BUCKET)
    for name, at in bucket.items():
        one_song = next(iter(at))
        if one_song not in shapes[name]:
            raise AssertionError(f"no {name} launch at the 30 s bucket's {one_song}: its frame count here is off")
    # a batch chunk's one launch of the salience envelope and (the template chunk) of the constant-switch Viterbi
    for name in ("salience_envelope", "constant_switch_viterbi"):
        chunk = (CHUNK_SONGS[0], *next(iter(bucket[name]))[1:])
        if chunk not in shapes[name]:
            raise AssertionError(f"no {name} launch at a chunk's {chunk}: the batch launched {sorted(shapes[name])}")
    long_shapes = decoder_shapes_at(LONG_SONG_S)
    print(f"the {LONG_SONG_S} s song: shapes {[list(at) for at in long_shapes.values()]} "
          f"(the 30 s bucket: {[next(iter(at)) for at in bucket.values()]})")
    out, spills = {}, []
    for name, by_shape in shapes.items():
        kernel, plain = calls[name]
        rows, err = {}, 0.0
        # shapes no path launched: the 180 s song's (the long phase launches
        # them at [1, ...]; the rest are held here), another layout's; and
        # for the DBN the tempo grids of its general layout
        long_at = long_shapes.get(name, {})
        extra = {shape: c for shape, c in (long_at | OTHER_LAYOUT_SHAPES.get(name, {})).items() if shape not in by_shape}
        jobs = [(shape, launched, None) for shape, launched in sorted(by_shape.items())] + [(shape, None, None) for shape in sorted(extra)]
        if name == "dbn_viterbi":
            jobs += [((1, beat_frames(Settings().PAD_SECONDS_BUCKET, fps=grid[2])), None, grid) for grid in DBN_GRIDS]
        for shape, launched, grid in jobs:
            held = launched is None
            long_song = grid is None and shape in long_at
            like = shapes[name][next(iter(bucket[name]))][0] if held else launched[0]
            if grid is not None:  # the DBN's arguments: (activations, fps, min_bpm, max_bpm, transition and observation lambdas)
                like = (like[0], grid[2], grid[0], grid[1], *like[4:])
            made = decoder_inputs(name, shape, like, rng)
            if grid is not None:
                cases = {k: made[k] for k in DBN_GRID_CASES}
            elif held:
                cases = {k: made[k] for k in extra[shape]}
            else:  # at the long song's shapes, its launched inputs and the inputs named there
                cases = {f"launched {i}": a for i, a in enumerate(launched)} | ({k: made[k] for k in long_at[shape]} if long_song else made)
            for case, args in cases.items():
                got, ref = kernel(*args), plain(*args)
                torch.cuda.synchronize()
                for g, r in zip(got if isinstance(got, tuple) else (got,), ref if isinstance(ref, tuple) else (ref,)):
                    err = max(err, abs_err(g, r))
                    if not same(g, r):
                        differ = g != r if not g.is_floating_point() else ~((g == r) | (g.isnan() & r.isnan()))
                        raise AssertionError(f"{name} kernel differs from its plain version at {shape} ({case}) in "
                                             f"{int(differ.sum())} of {g.numel()} elements")
            if long_song and shape[0] > 1:
                print(f"{name} {'x'.join(map(str, shape))}: bit-equal to the plain version on {', '.join(cases)} (the {LONG_SONG_S} s song, not timed)")
                continue
            args = next(iter(cases.values())) if held else like
            once = held or long_song  # plain loops of seconds: timed once, after the checks' runs
            with Capture(_build, "launch") as op_launch:
                kernel(*args)
            (launch_args, launch_kw, _), = op_launch.calls
            adds, compares, nbytes = decoder_work(name, args, mods)
            row = dict(
                ms=cuda_ms(lambda: _build.launch(*launch_args, **launch_kw), reps=20),
                single_ms=cuda_ms(lambda: _build.launch(*launch_args, **launch_kw), reps=10, spin=False),
                device_ms=device_ms(lambda: _build.launch(*launch_args, **launch_kw), reps=10, key=f"{name}_kernel"),
                wrapper_ms=cuda_ms(lambda: kernel(*args), reps=10),
                plain_ms=cuda_ms(lambda: plain(*args), reps=1, warmup=0) if once else cuda_ms(lambda: plain(*args), reps=3, warmup=1),
                adds=adds, compares=compares, bytes=nbytes,
                ops_bound_ms=max(adds / add_rate, compares / compare_rate) * 1e3, byte_bound_ms=nbytes / HBM_BYTES_PER_S * 1e3,
                frames=shape[-2] if name in ("banded_viterbi", "dense_viterbi") else shape[-1],
                cases=sorted(cases), launched=sum(1 for r in recorder.launches if (r.kernel, r.shape) == (name, shape)),
                long_song=long_song, other_layout=held and not long_song and grid is None, grid=list(grid) if grid else None,
            )
            row["bound_ms"] = max(row["ops_bound_ms"], row["byte_bound_ms"])
            row["bound_by"] = "operations" if row["ops_bound_ms"] >= row["byte_bound_ms"] else "bytes"
            row["ms_per_frame"] = row["ms"] / row["frames"]
            label = "x".join(map(str, shape)) + (f" at {grid[0]:g}-{grid[1]:g} bpm, {grid[2]} fps" if grid else "")
            rows[label] = row
            print(f"{name} {label}: bit-equal to the plain version on {len(cases)} inputs ({', '.join(sorted(cases))}); "
                  f"kernel {row['ms']:.4f} ms by events ({row['single_ms']:.4f} ms without the spin kernel, {row['device_ms']} ms "
                  f"in the profiler), {row['ms_per_frame'] * 1e3:.3f} us per frame; the wrapper with torch's preparation "
                  f"{row['wrapper_ms']:.4f} ms; plain loop on the card {row['plain_ms']:.2f} ms; bound {row['bound_ms']:.6f} ms by "
                  f"{row['bound_by']} ({adds} adds, {compares} compares, {nbytes} bytes); launched {row['launched']} times by the paths")
        usage = _build.ptxas_usage(name)
        print(f"ptxas {name}: {usage}")
        spills += [f"{fn} spills registers: {u}" for fn, u in usage.items() if u.get("spill_stores", 0) or u.get("spill_loads", 0)]
        out[name] = {"rows": rows, "ptxas": usage, "max_abs_err": err}
    if spills:  # after every kernel was held and timed
        raise AssertionError("; ".join(spills))
    return out


def decoder_entry(name: str, measured: dict, main_path: dict, batch: dict, by_path: dict, path: str) -> dict:
    """The kernels-line entry of a decoder kernel: its launches in one warm
    song of its path (``main_path``: the CLI under the shipped settings, or
    the template backend's for the constant-switch Viterbi; ``by_path``, each
    path's count), and its time (the kernel on prepared inputs, by events and
    in the profiler), the wrapper's, the plain time and the bound summed over
    that song's launch shapes (the bound from the song's total operations and
    bytes)."""
    rows = [measured["rows"]["x".join(map(str, shape))] for shape in main_path["decoder_shapes"][name]]
    ops_ms, byte_ms = sum(r["ops_bound_ms"] for r in rows), sum(r["byte_bound_ms"] for r in rows)
    return {
        "name": name,
        "route": "cuda",
        "source": f"audiotabs_tpu_torch/csrc/{name}.cu",
        "replaces": DECODERS[name][1],
        "path": path,
        "launches": main_path["decoder_launches"][name],
        "launches_per_batch_chunk": [c[name] for c in batch["decoder_launches_per_chunk"]],
        "launches_by_path": by_path,
        "launches_in_traced_song": main_path["traced"]["decoders"][name],
        "device_ms_in_traced_song": main_path["traced"]["decoder_ms"][name],
        "max_abs_err": measured["max_abs_err"],
        "ms": sum(r["ms"] for r in rows),
        "device_ms": None if any(r["device_ms"] is None for r in rows) else sum(r["device_ms"] for r in rows),
        "wrapper_ms": sum(r["wrapper_ms"] for r in rows),
        "plain_ms": sum(r["plain_ms"] for r in rows),
        "bound_ms": max(ops_ms, byte_ms),
        "bound_by": "operations" if ops_ms >= byte_ms else "bytes",
        # no one PyTorch call computes this decoder bit-equal (for the envelope, a cummax over
        # powers of 0.6 rounds otherwise than the scan's multiply-then-max)
        "library_ms": None,
        "shapes_per_song": ["x".join(map(str, shape)) for shape in main_path["decoder_shapes"][name]],
        "ms_per_frame_per_song": sum(r["ms_per_frame"] for r in rows),
        "by_shape": measured["rows"],
        "long_song": {label: {k: r[k] for k in ("ms", "plain_ms", "ms_per_frame", "bound_ms")}
                      for label, r in measured["rows"].items() if r["long_song"]},
        "other_layout": {label: {k: r[k] for k in ("ms", "plain_ms", "ms_per_frame", "bound_ms")}
                         for label, r in measured["rows"].items() if r["other_layout"]},
        "tempo_grids": {label: {k: r[k] for k in ("ms", "wrapper_ms", "plain_ms", "ms_per_frame", "bound_ms", "bound_by")}
                        for label, r in measured["rows"].items() if r["grid"]},
        "ptxas": measured["ptxas"],
    }


TRAIN_DIR = REPO / "build" / "chip_smoke_train"  # git-ignored: checkpoint copies and trainer outputs
HTDEMUCS_TRAIN = dict(n_clips=8, steps=10, batch=4, seed=0, sources=6, n_val=2)
GRAD_RTOL = 1e-3  # card against CPU: step-0 loss and global gradient norm
# median launches per trainer in the train phase, counted from the code (PERF.md §6)
MEDIAN_LAUNCHES_BY_TRAINER = {"htdemucs": 8, "beat_rnn": 20, "key_cnn": 124, "deepchroma": 36, "crf_chords": 140, "basicpitch": 24}
# decoder launches per trainer, counted from the code: htdemucs' gates decode
# the beats of 2 validation clips from the separated and from the HPSS drums
# (4); the BLSTM's three evaluations (its epoch, the ensemble, the onset
# baseline) the beats of 8 validation clips each (24); DeepChroma's gates
# CRF-decode 10 clips twice (the net's chroma, the salience chroma: 20); the
# CRF trainer decodes 30 selection clips for each of 24 (tau, alpha), 30
# validation clips twice and the 6 held-out clips twice (792). Salience
# envelopes: the key CNN's Krumhansl baseline on its 24 validation clips
# (chords/extract.py::chroma_features), DeepChroma's salience chroma of its 10
# validation clips, Basic Pitch's salience baseline on its 12 validation and
# the 6 held-out clips (18)
DECODER_LAUNCHES_BY_TRAINER = {
    "htdemucs": {"dbn_viterbi": 4},
    "beat_rnn": {"dbn_viterbi": 24},
    "key_cnn": {"salience_envelope": 24},
    "deepchroma": {"dense_viterbi": 20, "salience_envelope": 10},
    "crf_chords": {"dense_viterbi": 792},
    "basicpitch": {"salience_envelope": 18},
}


def timed_steps(name: str, step, dev: torch.device, n: int = 6) -> dict:
    """``n`` calls of ``step(i)`` (one update each, returning its loss on the
    card), each timed by CUDA events; every loss must be finite."""
    from audiotabs_tpu_torch.train.optim import StepTimer

    timer, losses = StepTimer(dev), []
    timer.mark()
    for i in range(n):
        losses.append(step(i))
        timer.mark()
    ms = timer.ms()
    losses = [float(v) for v in losses]
    if not all(np.isfinite(losses)):
        raise AssertionError(f"{name}: a training loss is not finite: {losses}")
    row = {"losses": losses, "step_ms": ms, "warm_step_ms": statistics.median(ms[1:])}
    print(f"train {name} update steps:", json.dumps(row))
    return row


def train_phase(recorder: RecordLaunches, dev: torch.device = torch.device("cuda")) -> dict:
    """``train_trainers`` in a fresh ``TRAIN_DIR``, with the trainers' dataset
    caches (under ``tempfile.gettempdir()``) kept in it, so that every run
    builds its datasets on this device and makes the same median launches."""
    shutil.rmtree(TRAIN_DIR, ignore_errors=True)
    (TRAIN_DIR / "tmp").mkdir(parents=True)
    old_tmp, tempfile.tempdir = tempfile.tempdir, str(TRAIN_DIR / "tmp")
    try:
        out = train_trainers(recorder, dev)
    finally:
        tempfile.tempdir = old_tmp
    if out["launches"] != MEDIAN_LAUNCHES_BY_TRAINER:
        raise AssertionError(f"median launches by trainer {out['launches']}, counted from the code {MEDIAN_LAUNCHES_BY_TRAINER}")
    expect = {t: dict.fromkeys(DECODERS, 0) | n for t, n in DECODER_LAUNCHES_BY_TRAINER.items()}
    if out["decoder_launches"] != expect:
        raise AssertionError(f"decoder launches by trainer {out['decoder_launches']}, counted from the code {expect}")
    return out


def train_trainers(recorder: RecordLaunches, dev: torch.device) -> dict:
    """The port's trainers on the card (all six), with the median launches they make.

    htdemucs at the shipped width: resumed from a copy of the shipped
    checkpoint (6 sources, 24 channels, 192-wide bottom, 3 transformer
    layers, 131,072-sample segments at 44.1 kHz), 10 steps of batch 4 through
    ``htdemucs_train.train`` with 2 validation clips; its first batch's loss
    and global gradient norm against the CPU's (TF32 off; ``step0``). The
    other five at their shipped widths: update steps on batches from each
    trainer's own dataset function, timed, then ``train()`` at a few steps
    and clips, gates and all."""
    from audiotabs_tpu_torch.models import basicpitch, beat_rnn, deepchroma, htdemucs, key_cnn
    from audiotabs_tpu_torch.models.params_io import WEIGHTS_DIR
    from audiotabs_tpu_torch.train import basicpitch_train, beat_rnn_train, crf_chords_train, deepchroma_train
    from audiotabs_tpu_torch.train import htdemucs_train, key_cnn_train
    from audiotabs_tpu_torch.train.optim import Trainer

    launches, decoders, result = {}, {}, {}

    def gates(name: str, res: dict) -> None:
        report = {k: v for k, v in res.items() if k not in ("params", "losses", "step_ms")}
        print(f"train {name} gates ({'saved' if res.get('saved') else 'NOT saved'}):", json.dumps(report, default=str))

    # htdemucs: step 0 on the card and on the CPU, then train() on the card
    ckpt = TRAIN_DIR / "htdemucs.npz"
    shutil.copyfile(WEIGHTS_DIR / "htdemucs.npz", ckpt)
    params = htdemucs.load_params(str(ckpt))
    cfg = HTDEMUCS_TRAIN
    mixes, stems, _ = htdemucs_train.build_clips(cfg["n_clips"], cfg["seed"], n_sources=cfg["sources"])
    sel = np.random.default_rng(cfg["seed"]).choice(cfg["n_clips"], size=cfg["batch"], replace=False)  # train()'s first batch

    def grad_norm(net) -> float:
        return float(torch.sqrt(sum((p.grad.double() ** 2).sum() for p in net.parameters())))

    def step0(device: torch.device, signs=None) -> dict:
        """The first batch's loss and gradient norm on ``device``. The loss is
        L1, whose gradient is the sign of each residual: residuals within
        float noise of zero can take either sign on the two devices. So the
        norm is also taken with the residual signs fixed to ``signs`` (the
        card's), which is the same loss value wherever a sign is not in doubt."""
        net = htdemucs_train.trainable(params, device)
        mb, sb = torch.from_numpy(mixes[sel]).to(device), torch.from_numpy(stems[sel]).to(device)
        loss = htdemucs_train.loss_fn(net, mb, sb)
        loss.backward()
        out = {"loss": float(loss.detach()), "grad_norm": grad_norm(net), "n_params": sum(p.numel() for p in net.parameters())}
        net.zero_grad(set_to_none=True)
        pred = net(mb)
        res_s, res_r = pred - sb, pred.sum(dim=1) - mb
        s_s, s_r = (torch.sign(res_s.detach()), torch.sign(res_r.detach())) if signs is None else (t.to(device) for t in signs)
        # htdemucs_train.loss_fn with |r| written as sign(r) · r
        level = sb.abs().mean(dim=(2, 3)) + 0.02
        fixed = ((s_s * res_s).mean(dim=(2, 3)) / level).mean() + 2.0 * (s_r * res_r).mean()
        fixed.backward()
        out.update(fixed_loss=float(fixed.detach()), fixed_grad_norm=grad_norm(net), signs=(s_s.cpu(), s_r.cpu()),
                   near_zero=float((res_r.detach().abs() < 1e-5).float().mean()))
        return out

    t0 = time.perf_counter()
    card = step0(dev)
    if not abs(card["fixed_loss"] - card["loss"]) <= 1e-5 * card["loss"]:
        raise AssertionError(f"the sign-fixed loss {card['fixed_loss']} is not the training loss {card['loss']}")
    cpu = step0(torch.device("cpu"), card["signs"])
    card_loss, card_norm, cpu_loss, cpu_norm, n_params = card["loss"], card["fixed_grad_norm"], cpu["loss"], cpu["fixed_grad_norm"], card["n_params"]
    print(f"train htdemucs step 0, card vs cpu ({time.perf_counter() - t0:.1f} s): loss {card_loss!r} / {cpu_loss!r}; "
          f"grad norm with the card's residual signs {card_norm!r} / {cpu_norm!r}; with each device's own signs "
          f"{card['grad_norm']!r} / {cpu['grad_norm']!r} (mix residuals within 1e-5 of zero: {card['near_zero']!r} / {cpu['near_zero']!r})")
    for what, a, b in (("loss", card_loss, cpu_loss), ("grad norm (the card's residual signs)", card_norm, cpu_norm)):
        if not abs(a - b) <= GRAD_RTOL * abs(b):
            raise AssertionError(f"htdemucs step-0 {what} on the card {a} is not within rtol {GRAD_RTOL} of the CPU's {b}")

    count = Launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = htdemucs_train.train(out_path=str(ckpt), resume=True, device=dev, **cfg)
    wall = time.perf_counter() - t0
    launches["htdemucs"], decoders["htdemucs"] = count.median, count.decoders
    losses = res["losses"]
    if len(losses) != cfg["steps"] or not all(np.isfinite(losses)):
        raise AssertionError(f"htdemucs training losses: {losses}")
    if not abs(losses[0] - card_loss) <= GRAD_RTOL * abs(card_loss):
        raise AssertionError(f"train()'s first loss {losses[0]} is not the step-0 loss {card_loss}")
    result["htdemucs"] = {
        "losses": losses, "step_ms": res["step_ms"], "warm_step_ms": statistics.median(res["step_ms"][1:]),
        "peak_gib": torch.cuda.max_memory_allocated() / 2**30, "wall_s": wall, "saved": res["saved"],
        "step0": {"loss": [card_loss, cpu_loss], "grad_norm_card_signs": [card_norm, cpu_norm],
                  "grad_norm_own_signs": [card["grad_norm"], cpu["grad_norm"]]},
        "params_m": n_params / 1e6,
    }
    print("train htdemucs:", json.dumps({k: v for k, v in result["htdemucs"].items()}))
    gates("htdemucs", res)

    rng = np.random.default_rng(0)

    def run(name: str, steps_fn, train_fn) -> None:
        count = Launches()
        t0 = time.perf_counter()
        row = timed_steps(name, steps_fn(), dev)
        res = train_fn()
        row["wall_s"] = time.perf_counter() - t0
        row["saved"] = bool(res.get("saved"))
        launches[name], decoders[name] = count.median, count.decoders
        gates(name, res)
        result[name] = row

    def beat_steps():
        X, Y, _ = beat_rnn_train.build_dataset(2, 0, device=dev)
        Xw, Yw = beat_rnn_train.windows(X, Y)
        member = {k: v for k, v in beat_rnn.load_params().items() if k != "ensemble"}
        net = beat_rnn_train.trainable(member, dev)
        tr = Trainer([p for p in net.parameters() if p.requires_grad], 2e-3, 6, alpha=0.05)

        def step(i):
            b = rng.choice(len(Xw), size=32, replace=False)
            return beat_rnn_train.update(net, tr, torch.from_numpy(Xw[b]).to(dev), torch.from_numpy(Yw[b]).to(dev), 18.0)

        return step

    def key_steps():
        X, Y, _ = key_cnn_train.build_clips(16, 0, dev)
        net = key_cnn.KeyCNN.from_params(key_cnn.load_params()).to(dev)
        tr = Trainer(net.parameters(), 2e-3, 6, alpha=0.05, weight_decay=1e-4)

        def step(i):
            b = rng.choice(16, size=16, replace=False)
            xb, yb = key_cnn_train.augment_batch(X[b], Y[b], rng)
            return key_cnn_train.update(net, tr, torch.from_numpy(xb).to(dev), torch.from_numpy(yb).to(dev))

        return step

    def deepchroma_steps():
        X, Y, _, _ = deepchroma_train.build_dataset(4, 0, dev)
        net = deepchroma_train.trainable(deepchroma.load_params(), dev)
        tr = Trainer(net.parameters(), 1e-3, 6, alpha=0.05, weight_decay=1e-4)
        gen = torch.Generator(device=dev).manual_seed(0)

        def step(i):
            b = rng.integers(0, X.shape[0], size=256)
            xb, yb = deepchroma_train.augment_batch(X[b], Y[b], rng)
            return deepchroma_train.update(net, tr, torch.from_numpy(xb).to(dev), torch.from_numpy(yb).to(dev),
                                           deepchroma_train.dropout_masks(net, 256, gen))

        return step

    def crf_steps():
        X_clips, Y_clips = crf_chords_train.build_dataset(4, 0, deepchroma.load_params(), device=dev)
        X = np.concatenate([crf_chords_train._ctx_stack_np(x, 3) for x in X_clips])
        Y = np.concatenate(Y_clips)
        w = torch.nn.Parameter(torch.from_numpy(crf_chords_train.template_init(3)).to(dev))
        tr = Trainer([w], 1e-2, 6, alpha=0.05)

        def step(i):
            b = rng.integers(0, X.shape[0], size=512)
            return crf_chords_train.update(w, tr, torch.from_numpy(X[b]).to(dev), torch.from_numpy(Y[b]).to(dev))

        return step

    def basicpitch_steps():
        clips = basicpitch_train.build_clips(8, 0)
        n_frames = int(basicpitch_train.CLIP_S * 22050) // basicpitch.HOP + 1
        audio = np.stack([c[0] for c in clips]).astype(np.float32)
        rolls = [basicpitch_train.rolls_from_events(ev, n_frames) for _, ev in clips]
        arrays = [audio] + [np.stack([r[k] for r in rolls]) for k in range(3)]
        net = basicpitch.BasicPitchCNN.from_params(basicpitch.load_params()).to(dev)
        tr = Trainer(net.parameters(), 3e-3, 6, alpha=0.05)

        def step(i):
            b = rng.choice(8, size=8, replace=False)
            return basicpitch_train.update(net, tr, *(torch.from_numpy(a[b]).to(dev) for a in arrays))

        return step

    run("beat_rnn", beat_steps, lambda: beat_rnn_train.train(
        n_clips=2, epochs=1, batch=32, ensemble=1, out_path=str(TRAIN_DIR / "beat_rnn.npz"), device=dev))
    run("key_cnn", key_steps, lambda: key_cnn_train.train(
        n_clips=16, steps=5, batch=16, out_path=str(TRAIN_DIR / "key_cnn.npz"), device=dev))
    run("deepchroma", deepchroma_steps, lambda: deepchroma_train.train(
        n_clips=4, steps=5, batch=256, out_path=str(TRAIN_DIR / "deepchroma.npz"), device=dev))
    run("crf_chords", crf_steps, lambda: crf_chords_train.train(
        n_clips=4, steps=5, batch=512, out_path=str(TRAIN_DIR / "crf_chords.npz"), device=dev))
    run("basicpitch", basicpitch_steps, lambda: basicpitch_train.train(
        n_clips=8, steps=5, batch=8, out_path=str(TRAIN_DIR / "basicpitch.npz"), device=dev))

    print(f"train decoder launches by trainer: {json.dumps(decoders)}")
    total = sum(launches.values())
    if total == 0 or len(recorder.launches) != total:
        raise AssertionError(f"training launched the median kernel {total} times, {len(recorder.launches)} through HPSS")
    shapes = collections.Counter(f"{'x'.join(map(str, shape))} win {win} axis {axis}" for shape, win, axis in recorder.sites())
    print(f"train median launches: {total} ({launches}); by shape {dict(shapes)}")
    return {"launches": launches, "decoder_launches": decoders, "total": total, "by_shape": dict(shapes), "trainers": result}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    from concurrent.futures import ThreadPoolExecutor

    from audiotabs_tpu_torch import _build
    from audiotabs_tpu_torch.config import Settings
    from audiotabs_tpu_torch.io.wav import decode_for_analysis, peak_normalize
    from audiotabs_tpu_torch.ops import median
    from audiotabs_tpu_torch.runtime import pipeline
    from audiotabs_tpu_torch.runtime.fused import fused_analysis

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print("tf32: off for cuDNN and for matmul")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    mods = decoder_modules()
    with ThreadPoolExecutor(len(DECODERS) + 1) as pool:  # one nvcc for each source, all started together
        builds = [pool.submit(_build.build, "median_filter", median._headers())] + [pool.submit(_build.build, n) for n in DECODERS]
        for b in builds:
            b.result()
    print(f"build: median_filter.cu, {', '.join(f'{n}.cu' for n in DECODERS)} in {time.perf_counter() - t0:.2f} s (in parallel)")
    if sys.argv[1:] == ["strum"]:
        t0 = time.perf_counter()
        strum_phase(card)
        print(f"phase strum: {time.perf_counter() - t0:.2f} s")
        return 0

    t_run = time.perf_counter()

    dec_recorder = RecordLaunches(DECODERS, keep=2)

    def run_phase(name, fn):
        t0 = time.perf_counter()
        dec_recorder.tag = name
        out = fn()
        print(f"phase {name}: {time.perf_counter() - t0:.2f} s")
        return out

    kernel = run_phase("kernel", lambda: check_kernel(median))

    y, sr, _ = decode_for_analysis(CLIP, pipeline.ANALYSIS_SR)
    y = peak_normalize(y)
    y_pad = np.ascontiguousarray(pipeline._pad_to_bucket(y, sr, 30.0), dtype=np.float32)
    run_phase("separation", lambda: separation_phase(y_pad, sr))

    # every decoder kernel launch from here to the end of the train phase is
    # recorded (its shape, and its first inputs at each shape), for the decoders phase
    with dec_recorder:
        # the main path: the CLI under the shipped settings
        main_path = run_phase("cli", lambda: cli_phase(dec_recorder, card))
        # the job plane and the batch runner under the shipped settings
        serve_launches = run_phase("serve", lambda: serving_phase(card, main_path["out"]["result.json"]))
        batch = run_phase("batch", lambda: batch_phase(card))
        mesh = run_phase("mesh", lambda: mesh_phase(card, batch))
        batch8 = run_phase("batch8", lambda: batch8_phase(card))

        def analysis_phase():
            """run_analysis under the shipped settings, separation on; the stems it
            separates are kept, so the CPU can run the fused analysis on the same inputs."""
            shipped = Settings()
            if not shipped.ENABLE_DEMUCS:
                raise AssertionError("the shipped settings do not separate")
            used = {}
            separate = pipeline.separate_stems_device

            def keep_stems(*args, **kwargs):
                used.clear()
                used.update(separate(*args, **kwargs))
                return used

            pipeline.separate_stems_device = keep_stems
            try:
                feats, beats, info, launches = drive(shipped, MEDIAN_LAUNCHES_PER_SONG)
            finally:
                pipeline.separate_stems_device = separate
            if info != {"stem_source": "guitar", "errors": []}:
                raise AssertionError(f"the shipped path did not separate cleanly: {info}")
            check_outputs(feats, beats, FUSED_DEEP_KEYS | {"beat_from_drums"})
            print(f"beat_from_drums {bool(feats['beat_from_drums'])}")

            with torch.inference_mode():
                cpu_out = fused_analysis(used["guitar"].cpu(), sr, chord_backend="deep", true_len=len(y),
                                         y_beat=used["drums"].cpu(), y_mix=torch.from_numpy(y_pad))
                cpu_feats = pipeline.features_to_host(cpu_out)
            compare_with_cpu("card stems, cuda vs cpu fused", cpu_feats, feats)
            t100 = int(len(y) / sr * 100)
            cpu_beats = pipeline.beats_from_decoded(cpu_feats["dbn_phases"][:t100], cpu_feats["dbn_intervals"][:t100],
                                                    np.asarray(cpu_feats["beat_activation"], dtype=np.float32)[:t100], fps=100)
            if not np.array_equal(cpu_beats, beats):
                raise AssertionError("beat times differ between cuda and cpu on the card's stems")
            print(f"card stems, cuda vs cpu fused: discrete outputs and beat times equal; floats within {FLOAT_TOL}, f16 outputs within {F16_TOL}")

            stage_times(y_pad, sr)
            profile_busy_share(lambda: pipeline.run_analysis(CLIP, device="cuda", settings=shipped))

            # the whole pipeline on the CPU, on its own stems, against the card's CLI run
            t0 = time.perf_counter()
            with Capture(pipeline, "features_to_host") as cpu_host:
                cpu_res = pipeline.run_pipeline(JOBS / "cpu", CLIP, device="cpu", settings=shipped)
            print(f"cpu run_pipeline (shipped settings, own stems): {time.perf_counter() - t0:.3f} s, errors {cpu_res.transcription_error}")
            e2e_feats = cpu_host.last
            agree = {k: f"{int((e2e_feats[k] == feats[k]).sum())} of {feats[k].size}" for k in DISCRETE + ("beat_from_drums",)}
            print(f"end to end, cuda vs cpu (each on its own stems): equal elements {agree}")
            compare_pipelines(main_path["out"], cpu_res, read_out(JOBS / "cpu"))
            return launches

        def mix_phase():
            """The ENABLE_DEMUCS=False path, as before."""
            off = dataclasses.replace(Settings(), ENABLE_DEMUCS=False)
            off_feats, off_beats, off_info, off_launches = drive(off, len(MAIN_PATH_MEDIANS))
            if off_info != {"stem_source": "mix", "errors": []}:
                raise AssertionError(f"unexpected ENABLE_DEMUCS=False run: {off_info}")
            check_outputs(off_feats, off_beats, FUSED_DEEP_KEYS)
            t0 = time.perf_counter()
            cpu_feats, cpu_beats, _ = pipeline.run_analysis(CLIP, device="cpu", settings=off)
            print(f"cpu run_analysis (ENABLE_DEMUCS=False): {time.perf_counter() - t0:.3f} s")
            compare_with_cpu("mix, cuda vs cpu", cpu_feats, off_feats)
            if not np.array_equal(cpu_beats, off_beats):
                raise AssertionError("beat times differ between cuda and cpu")
            print(f"mix, cuda vs cpu: discrete outputs and beat times equal; floats within {FLOAT_TOL}, f16 outputs within {F16_TOL}")
            return off_launches

        launches = run_phase("analysis", analysis_phase)
        off_launches = run_phase("mix", mix_phase)
        decode = run_phase("decode", lambda: decode_phase(card, main_path["out"]["result.json"]))
        with RecordLaunches(["median_filter"]) as recorder:
            cases = {name: run_phase(name, lambda name=name: settings_phase(card, name, recorder)) for name in SETTINGS_CASES}
            degraded = run_phase("degraded", lambda: degraded_phase(card, recorder))
        new_shapes = run_phase("new shapes", lambda: new_shape_kernel_check(recorder))
        run_phase("strum", lambda: strum_phase(card))
        long_recorder = RecordLaunches(["median_filter"], keep=2)
        long_song = run_phase("long", lambda: long_phase(long_recorder, card))
        long_shapes = run_phase("long shapes", lambda: new_shape_kernel_check(long_recorder))
        with RecordLaunches(["median_filter"], keep=4) as train_recorder:
            train = run_phase("train", lambda: train_phase(train_recorder))
    train_shapes = run_phase("train shapes", lambda: new_shape_kernel_check(train_recorder))
    decoders = run_phase("decoders", lambda: decoders_phase(mods, dec_recorder, kernel["sm_clock_mhz"]))
    print(f"all phases: {time.perf_counter() - t_run:.2f} s")

    # each decoder kernel's own path: the CLI under the shipped settings, the
    # template backend (majmin7) for the constant-switch Viterbi (its counted song; the traced one came after)
    template = dict(cases["template"], decoder_shapes={
        name: [r.shape for r in dec_recorder.launches if (r.kernel, r.tag) == (name, "template")][: cases["template"]["decoder_launches"][name]]
        for name in DECODERS})
    own_path = {name: (main_path, "cli, shipped settings") for name in DECODERS}
    own_path["constant_switch_viterbi"] = (template, "cli, CHORD_DETECTION_BACKEND=template, CHORD_VOCAB=majmin7")
    print(json.dumps({"kernels": [{
        "name": "median_filter",
        "route": "cuda",
        "source": "audiotabs_tpu_torch/csrc/median_filter.cu",
        "replaces": "audiotabs_tpu/ops/pallas_median.py:31",
        "launches": main_path["launches"],
        "launches_run_analysis": launches,
        "launches_without_separation": off_launches,
        "launches_per_batch_chunk": batch["launches_per_chunk"],
        "launches_mesh": {"default_mesh_per_chunk": mesh["launches_default_mesh_per_chunk"],
                          "two_way_by_batch": mesh["launches_two_way"]},
        "launches_inline_and_queued_job": serve_launches,
        "launches_upload_jobs": {k: v["launches"] for k, v in decode.items() if k not in ("decoders", "resampler_vs_scipy")},
        "launches_notes": cases["notes"]["launches"],
        "launches_template": [cases["template"]["launches"], cases["template_majmin7plus"]["launches"]],
        "launches_content_window": cases["content"]["launches"],
        "launches_degraded": degraded["runs"][-1]["launches"],
        "launches_train": train["total"],
        "launches_train_by_trainer": train["launches"],
        "launches_train_by_shape": train["by_shape"],
        "launches_long_song": long_song["launches"],
        "launches_batch_of_8_per_chunk": batch8["launches_per_chunk"],
        "max_abs_err": max(kernel["max_abs_err"], mesh["new_shapes"]["max_abs_err"], new_shapes["max_abs_err"], train_shapes["max_abs_err"],
                           long_shapes["max_abs_err"]),
        "ms": kernel["ms"],
        "plain_ms": kernel["plain_ms"],
        "bound_ms": kernel["bound_ms"],
        "bound_by": "bytes",
        "library_ms": kernel["plain_ms"],
        "ms_per_launch": kernel["per_launch"],
        "ms_per_batched_launch": kernel["batched"],
        "ms_per_launch_new_shapes": new_shapes["rows"],
        "ms_per_launch_mesh_shapes": mesh["new_shapes"]["rows"],
        "ms_per_launch_train_shapes": train_shapes["rows"],
        "ms_per_launch_long_song_shapes": long_shapes["rows"],
        "per_batch_chunk": kernel["per_chunk"],
        "single_ms": kernel["single_ms"],
        "device_ms": kernel["device_ms"],
        "issue_bound_ms": kernel["issue_bound_ms"],
        "sm_clock_mhz": kernel["sm_clock_mhz"],
        "fmnmx_per_output": kernel["fmnmx_per_output"],
        "ptxas": kernel["ptxas"],
    }] + [decoder_entry(name, decoders[name], own_path[name][0], batch, {
        "run_analysis": DECODER_LAUNCHES_PER_SONG[name],
        "inline_and_queued_job": DECODER_LAUNCHES_PER_SONG[name],
        "mesh_shard_of_b_rows": DECODER_LAUNCHES_PER_SONG[name],
        "template_batch_chunk_of_4": batch["template_chunk_decoders"][name],
        **{case: cases[case]["decoder_launches"][name] for case in SETTINGS_CASES},
        "degraded": degraded["runs"][-1]["decoder_launches"][name],
        "long_song_180_s": long_song["decoder_launches"][name],
        "batch_of_8_per_chunk": [c[name] for c in batch8["decoder_launches_per_chunk"]],
        "train_by_trainer": {t: n[name] for t, n in train["decoder_launches"].items()},
    }, own_path[name][1]) for name in DECODERS]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}))
    return 0

if __name__ == "__main__":
    sys.exit(main())
