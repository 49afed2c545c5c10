"""Smoke run of the PyTorch port on one NVIDIA GPU: build, check, time, drive.

    python3 chip_smoke.py

1. Prints the card's name and power limit, and turns TF32 off.
2. Builds the median kernel (csrc/median_filter.cu, with the selection
   networks that ops/median.py generates) with nvcc into build/, and prints
   ptxas's registers and spills for each instantiation (none may spill) and
   the min/max (FMNMX) per output of each network.
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
   with the launch count set to 0 just before it: 8 median launches per
   song, no ``transcription_error``, ``stem_source`` guitar with the drums
   as beat source and no separation error, the whole artifact set in
   ``out/`` and ``work/``; one device-to-host copy per song (profiler); the
   CPU ``_pipeline_tail`` fed the card's own host features and native audio
   writes byte-equal artifacts. Prints the cold and warm wall and every
   ``profile.json`` stage.
6. Drives ``run_analysis`` with the shipped settings (separation on): 8
   median launches per song, the guitar stem analysed, no stage error; the
   card's outputs against a CPU ``fused_analysis`` fed the card's own stems
   (discrete outputs and beat times equal). Times each stage and profiles one
   warm song. A CPU ``run_pipeline`` on its own stems must give the card's
   chords, key, time signature and beat times; its note agreement is printed.
7. Drives ``run_analysis`` with ``ENABLE_DEMUCS=False`` (the mix analysed):
   6 median launches per song, discrete outputs equal to the CPU run's.
8. Prints the kernel table as one JSON line, then the result line.

Any failed phase raises, and the script exits non-zero without a result. It
imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import collections
import dataclasses
import json
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent
CLIP = REPO / "tests" / "data" / "heldout" / "heldout_strum_band.wav"
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)
# float min/max per SM per clock on compute capability 9.0 (CUDA C++
# Programming Guide, throughput of native arithmetic instructions)
FMNMX_PER_SM_PER_CLOCK = 64
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
SEPARATED_LAUNCHES = len(MAIN_PATH_MEDIANS) + 2
EXTRA_MEDIANS = [((2, 1025, 1292), 31, -1), ((2, 1025, 1292), 31, -2)]
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
# what run_pipeline writes for this clip under the shipped settings (guitar mode)
OUT_ARTIFACTS = {
    "result.json", "beat_times.json", "chords.json", "threshold_calibration.json", "content_segments.json",
    "strum_onsets.json", "chosen_shapes.json", "tab_positions.json", "note_events.csv", "result.musicxml",
    "transcription.mid", "score.ly", "score.pdf", "profile.json",
}
WORK_ARTIFACTS = {"audio_mono_44k.wav", "audio_harmonic.wav"}
STAGES = ("decode", "separation", "analysis", "beats", "calibration", "transcription", "beat_select", "chords", "key",
          "mode", "quantize", "artifacts", "export")


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


def device_ms(fn, reps: int = 20) -> float | None:
    """Mean duration of one median kernel in torch.profiler's device trace
    (the kernel alone, without launch gaps), over the launches the trace
    holds; None if it holds none."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if "median_" in e.key]
    seen = sum(e.count for e in events)
    return sum(e.self_device_time_total for e in events) / seen / 1e3 if seen else None


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
    for shape, win, axis in MAIN_PATH_MEDIANS + EXTRA_MEDIANS:
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
        if (shape, win, axis) in MAIN_PATH_MEDIANS:
            per_launch[f"{'x'.join(map(str, shape))} win {win} axis {axis}"] = row["ms"]
            for k in ("ms", "single_ms", "device_ms", "plain_ms", "bound_ms", "issue_bound_ms"):
                total[k] = None if total[k] is None or row[k] is None else total[k] + row[k]
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
    total.update(per_launch=per_launch, fmnmx_per_output=fmnmx, sm_clock_mhz=mhz, ptxas=usage)
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
        "dbn loop (forward + backtrack)": lambda: _dbn_forward(act),
        "hcqt + basic pitch cnn": lambda: basicpitch.cnn_apply(m.basicpitch, basicpitch.hcqt(y_harm, sr)),
        "salience posteriors + chroma": lambda: salience_chroma(basicpitch.salience_posteriors(y_harm, sr)[1], 301),
        "deepchroma (features + dnn)": lambda: deepchroma.apply(m.deepchroma, deepchroma.features(y_harm, sr)[:301]),
        "crf (emissions + viterbi loop)": lambda: crf_chords.decode(m.crf, crf_feats),
        "key cnn (features + cnn)": lambda: key_cnn.apply(m.key, key_cnn.features(y_harm, sr)),
        "strum envelope": lambda: _onset_strength_median(y, sr, 512),
        "content windows (pyin, onset loop, 2 median launches)": lambda: _window_metrics(windows, sr),
        "calibration masks (2 median launches)": lambda: hpss_masks(S1024, 17, 17),
        "calibration onset loop": lambda: onset_detect_frames(onset_strength(y, sr, hop=512, n_fft=1024), delta=0.5, wait=4),
    }
    out = {}
    for name, fn in stages.items():
        out[name] = wall_s(fn)
        print(f"stage {name}: {out[name] * 1e3:.2f} ms")
    return out


def device_events(prof) -> list:
    """The trace's device activities (kernels, copies, sets), without CUPTI's own buffer events."""
    from torch.autograd import DeviceType

    return [e for e in prof.events() if e.device_type == DeviceType.CUDA and "Buffer" not in e.name]


def busy_ms(events: list) -> float:
    """Time during which at least one device activity ran (the union of their intervals), ms."""
    total, end = 0.0, float("-inf")
    for start, stop in sorted((e.time_range.start, e.time_range.end) for e in events):
        if stop > end:
            total += stop - max(start, end)
            end = stop
    return total / 1e3


def print_top(label: str, events: list, n: int = 8) -> None:
    by_name = collections.defaultdict(lambda: [0, 0.0])
    for e in events:
        by_name[e.name][0] += 1
        by_name[e.name][1] += e.time_range.elapsed_us()
    for name, (count, us) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[:n]:
        print(f"{label}: {name[:80]} count {count} device {us / 1e3:.2f} ms")


def profile_busy_share(run) -> int:
    """Device busy share of one warm song from torch.profiler (CUPTI); returns
    the song's device-to-host copies."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = device_events(prof)
    dtoh = sum(e.name.startswith("Memcpy DtoH") for e in events)
    print(f"profile: device-to-host copies per song {dtoh}")
    if not events:
        print("profile: no device time in the trace; busy share not measured")
        return dtoh
    busy = busy_ms(events)
    print(f"profile: wall {wall * 1e3:.1f} ms, device busy {busy:.1f} ms (kernel time summed {sum(e.time_range.elapsed_us() for e in events) / 1e3:.1f} ms), "
          f"busy share {busy / 1e3 / wall:.3f}, device ops {len(events)}")
    print_top("profile median", [e for e in events if "median_" in e.name])
    print_top("profile top", events)
    return dtoh


def compare_with_cpu(what: str, cpu: dict, card: dict) -> None:
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


def drive(median, settings, expect_launches: int) -> tuple:
    """run_analysis on the card: cold, then twice warm, each song with the launch count set to 0 just before it."""
    from audiotabs_tpu_torch.runtime.pipeline import run_analysis

    times = []
    for _ in range(3):
        median.LAUNCHES = 0
        t0 = time.perf_counter()
        feats, beats, info = run_analysis(CLIP, device="cuda", settings=settings)
        times.append(time.perf_counter() - t0)
        if median.LAUNCHES != expect_launches:
            raise AssertionError(f"median kernel launched {median.LAUNCHES} times in one song, expected {expect_launches}")
    print(f"run_analysis on {CLIP.name} (ENABLE_DEMUCS={settings.ENABLE_DEMUCS}): cold {times[0]:.3f} s, "
          f"warm {times[1]:.3f} s / {times[2]:.3f} s, median launches per song {median.LAUNCHES}, {info}")
    return feats, beats, info, median.LAUNCHES


def read_out(job: Path) -> dict:
    """A job's ``out/`` files: JSON parsed, the rest as bytes."""
    return {p.name: json.loads(p.read_text()) if p.suffix == ".json" else p.read_bytes() for p in sorted((job / "out").iterdir())}


class Capture:
    """Wraps a module function and keeps what its last call returned and how long it took."""

    def __init__(self, module, name: str):
        self.module, self.name, self.fn, self.last, self.seconds = module, name, getattr(module, name), None, None

    def __enter__(self):
        def keep(*args, **kwargs):
            t0 = time.perf_counter()
            self.last = self.fn(*args, **kwargs)
            self.seconds = time.perf_counter() - t0
            return self.last

        setattr(self.module, self.name, keep)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.fn)
        return False


def cli_phase(median, card: str) -> dict:
    """The main path: the port's CLI on the card under the shipped settings,
    cold and then twice warm; the artifacts checked, one warm song profiled,
    and the CPU tail run on the card's own host features."""
    from audiotabs_tpu_torch.config import Settings
    from audiotabs_tpu_torch.io.wav import decode_for_analysis, peak_normalize
    from audiotabs_tpu_torch.runtime import cli, pipeline

    shutil.rmtree(JOBS, ignore_errors=True)
    walls, cli_walls = [], []
    with Capture(pipeline, "features_to_host") as feats, Capture(pipeline, "run_pipeline") as result:
        for run in range(3):
            job = JOBS / f"cli{run}"
            median.LAUNCHES = 0
            t0 = time.perf_counter()
            rc = cli.main([str(CLIP), "--job-dir", str(job), "--keep"])
            cli_walls.append(time.perf_counter() - t0)
            launches = median.LAUNCHES
            walls.append(result.seconds)
            if rc != 0:
                raise AssertionError(f"cli exited {rc}")
            if launches != SEPARATED_LAUNCHES:
                raise AssertionError(f"median kernel launched {launches} times in one CLI song, expected {SEPARATED_LAUNCHES}")
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
                  f"host tail (beats to export) {tail_s:.4f} s, median launches {launches}, stages (s) {json.dumps(prof)} [{card}]")
        res = result.last
    if res.key_signature is None or not res.chords or res.score is None or res.transcription_backend != "guitar_hybrid":
        raise AssertionError(f"incomplete result: {res.to_json()[:400]}")
    print(f"cli on {CLIP.name}: run_pipeline cold {walls[0]:.3f} s, warm {walls[1]:.3f} s / {walls[2]:.3f} s; "
          f"key {res.key_signature.name}, {res.time_signature}, tempo {res.tempo_bpm:.2f}, {len(res.chords)} chords, "
          f"{len(res.score.measures)} measures, artifacts {sorted(OUT_ARTIFACTS)} + work {sorted(WORK_ARTIFACTS)} [{card}]")

    # one device-to-host copy per song
    dtoh = profile_busy_share(lambda: cli.main([str(CLIP), "--job-dir", str(JOBS / "cli_profiled"), "--keep"]))
    if dtoh != 1:
        raise AssertionError(f"{dtoh} device-to-host copies in one run_pipeline, expected 1")

    # the host tail on the CPU, on the card's own host features and native audio
    job = JOBS / "cli2"
    y, sr, (x_nat, sr_nat) = decode_for_analysis(CLIP, pipeline.ANALYSIS_SR)
    cpu_job = JOBS / "tail_cpu" / job.name
    tail = pipeline._pipeline_tail(
        feats=feats.last, y_harm=np.asarray(feats.last["y_harm"], dtype=np.float32)[: len(y)], true_len=len(y), sr=sr,
        out=cpu_job / "out", job_id=job.name, timer=pipeline.StageTimer(), errors=[], stem_source="guitar",
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
    return {"walls": walls, "launches": launches, "out": read_out(job)}


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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
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
    median.build()
    print(f"build: median_filter.cu in {time.perf_counter() - t0:.2f} s")

    kernel = check_kernel(median)

    y, sr, _ = decode_for_analysis(CLIP, pipeline.ANALYSIS_SR)
    y = peak_normalize(y)
    y_pad = np.ascontiguousarray(pipeline._pad_to_bucket(y, sr, 30.0), dtype=np.float32)
    separation_phase(y_pad, sr)
    print(f"separation measured on {card}")

    # the main path: the CLI under the shipped settings
    main_path = cli_phase(median, card)

    # run_analysis under the shipped settings, separation on; the stems it
    # separates are kept, so the CPU can run the fused analysis on the same inputs
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
        feats, beats, info, launches = drive(median, shipped, SEPARATED_LAUNCHES)
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

    # the ENABLE_DEMUCS=False path, as before
    off = dataclasses.replace(shipped, ENABLE_DEMUCS=False)
    off_feats, off_beats, off_info, off_launches = drive(median, off, len(MAIN_PATH_MEDIANS))
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

    print(json.dumps({"kernels": [{
        "name": "median_filter",
        "route": "cuda",
        "source": "audiotabs_tpu_torch/csrc/median_filter.cu",
        "replaces": "audiotabs_tpu/ops/pallas_median.py:31",
        "launches": main_path["launches"],
        "launches_run_analysis": launches,
        "launches_without_separation": off_launches,
        "max_abs_err": kernel["max_abs_err"],
        "ms": kernel["ms"],
        "plain_ms": kernel["plain_ms"],
        "bound_ms": kernel["bound_ms"],
        "bound_by": "bytes",
        "library_ms": kernel["plain_ms"],
        "ms_per_launch": kernel["per_launch"],
        "single_ms": kernel["single_ms"],
        "device_ms": kernel["device_ms"],
        "issue_bound_ms": kernel["issue_bound_ms"],
        "sm_clock_mhz": kernel["sm_clock_mhz"],
        "fmnmx_per_output": kernel["fmnmx_per_output"],
        "ptxas": kernel["ptxas"],
    }]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
