"""The loops that drive the program, and what the benchmark takes from it.

``Hooks`` replaces entry points of the program's modules with wrappers, on
the benchmark's side and for one run: they keep what the timed path
produced for the songs the check samples (the stems of ``separate_program``
and the host features of the one transfer), and, in a traced run, time each
layer with CUDA events, note the shapes that the median and DBN kernels are
launched on and open ``record_function`` spans for the trace."""

from __future__ import annotations

import contextlib
import dataclasses
import importlib
import json
import shutil
import time
from pathlib import Path

import numpy as np
import torch
from torch.profiler import record_function

from .songs import Song

SPANS = ("decode", "separation", "fused", "host_tail", "harness")


@dataclasses.dataclass
class Done:
    """One song of the window: its true length, its wall seconds (the call
    that completed it) and, in a traced run, its ``profile.json``."""

    song: Song
    wall_s: float
    error: str | None
    profile: dict | None = None


class Hooks:
    def __init__(self, trace: bool):
        htdemucs, hpss, batch_runner, fused, pipeline = (importlib.import_module(f"audiotabs_tpu_torch.{m}") for m in (
            "models.htdemucs", "ops.hpss", "runtime.batch_runner", "runtime.fused", "runtime.pipeline"))

        self.trace, self.recording = trace, False
        self.want: set[int] = set()  # the song indices the check compares
        self.current: list[int] = []  # the song indices the call in progress runs
        self.stems: dict[int, torch.Tensor] = {}
        self.feats: dict[int, dict[str, np.ndarray]] = {}
        self.events: dict[str, list] = {"separation": [], "fused": []}  # (start, end, songs)
        self.launches: dict[str, list] = {"median": [], "dbn": []}
        self._saved: list[tuple[object, str, object]] = []
        self._wrap(htdemucs, "separate_program", self._separation)
        for mod in (pipeline, batch_runner):
            self._wrap(mod, "features_to_host", self._transfer)
        self._wrap(pipeline, "fused_analysis", self._fused)
        self._wrap(batch_runner, "fused_analysis_batch", self._fused)
        if trace:
            self._wrap(pipeline, "decode_for_analysis", self._span("decode"))
            self._wrap(batch_runner, "_load_and_bucket", self._span("decode"))
            self._wrap(pipeline, "_pipeline_tail", self._span("host_tail"))
            self._wrap(hpss, "median_filter", self._median)
            self._wrap(fused, "_dbn_forward", self._dbn)

    def _wrap(self, module, name: str, make) -> None:
        fn = getattr(module, name)
        self._saved.append((module, name, fn))
        setattr(module, name, make(fn))

    def close(self) -> None:
        for module, name, fn in reversed(self._saved):
            setattr(module, name, fn)

    def _timed(self, kind: str, fn, args, kwargs, songs: int):
        if not (self.trace and self.recording):
            return fn(*args, **kwargs)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        with record_function(kind if kind in SPANS else "fused"):
            start.record()
            out = fn(*args, **kwargs)
            end.record()
        self.events[kind].append((start, end, songs))
        return out

    def _separation(self, fn):
        def wrapped(model, y, *args, **kwargs):
            stems = self._timed("separation", fn, (model, y) + args, kwargs, 1 if y.dim() == 1 else y.shape[0])
            rows = [stems] if y.dim() == 1 else list(stems)
            for i, s in zip(self.current[self._chunk_at:], rows):
                if i in self.want:
                    self.stems[i] = s
            self._chunk_at += len(rows)
            return stems
        self._chunk_at = 0
        return wrapped

    def _fused(self, fn):
        def wrapped(y, *args, **kwargs):
            return self._timed("fused", fn, (y,) + args, kwargs, 1 if y.dim() == 1 else y.shape[0])
        return wrapped

    def _transfer(self, fn):
        def wrapped(out):
            host = self._timed("fused", fn, (out,), {}, 0)
            single = host["y_harm"].ndim == 1
            rows = [host] if single else [{k: v[j] for k, v in host.items()} for j in range(host["y_harm"].shape[0])]
            for i, h in zip(self.current[self._rows_at:], rows):
                if i in self.want:
                    self.feats[i] = {k: np.array(v, copy=True) for k, v in h.items()}
            self._rows_at += len(rows)
            return host
        self._rows_at = 0
        return wrapped

    def _span(self, name: str):
        def make(fn):
            def wrapped(*args, **kwargs):
                if not self.recording:
                    return fn(*args, **kwargs)
                with record_function(name):
                    return fn(*args, **kwargs)
            return wrapped
        return make

    def _median(self, fn):
        def wrapped(x, *args, **kwargs):
            if self.recording and x.is_cuda:
                self.launches["median"].append(x.numel())
            return fn(x, *args, **kwargs)
        return wrapped

    def _dbn(self, fn):
        def wrapped(act, *args, **kwargs):
            if self.recording and act.is_cuda:
                shape = (1, act.shape[0]) if act.dim() == 1 else tuple(act.shape)
                names = ("fps", "min_bpm", "max_bpm")
                grid = dict(zip(names, args[: len(names)])) | {k: v for k, v in kwargs.items() if k in names}
                self.launches["dbn"].append((shape, grid))
            return fn(act, *args, **kwargs)
        return wrapped

    @contextlib.contextmanager
    def call(self, indices: list[int]):
        """One call of the program on the songs ``indices``, in its row order."""
        self.current = [i for i in indices]
        self._chunk_at = self._rows_at = 0
        try:
            yield
        finally:
            self.current = []

    def layer_ms(self) -> dict[str, tuple[float, int]]:
        """(device ms, songs) of each layer timed by events, the card synchronised first."""
        torch.cuda.synchronize()
        return {k: (sum(a.elapsed_time(b) for a, b, _ in ev), sum(n for *_, n in ev)) for k, ev in self.events.items()}


def _read_profile(job: Path) -> dict | None:
    path = job / "out" / "profile.json"
    return json.loads(path.read_text()) if path.exists() else None


def _beats(job: Path) -> object:
    path = job / "out" / "beat_times.json"
    return json.loads(path.read_text()) if path.exists() else None


class Loop:
    """A closed loop over the traffic's songs, one call after another, for
    ``seconds``: the window closes when the first call that ends after
    ``seconds`` has ended, so every call started in it counts, whole."""

    def __init__(self, kind: str, songs: list[Song], settings, hooks: Hooks, jobs: Path, batch: int = 1, device=None):
        self.kind, self.songs, self.settings, self.hooks, self.jobs, self.batch = kind, songs, settings, hooks, jobs, batch
        self.device = device  # None: the program's own default, the card
        self.results: dict[int, dict] = {}  # JobResult and beat times of each sampled song
        self._next = 0

    def _call(self, record: bool) -> list[Done]:
        from audiotabs_tpu_torch.runtime.batch_runner import transcribe_batch
        from audiotabs_tpu_torch.runtime.pipeline import run_pipeline

        n = len(self.songs)
        picked = [self.songs[(self._next + j) % n] for j in range(self.batch)]
        self._next += self.batch
        idx = [s.index for s in picked]
        error = None
        t0 = time.perf_counter()
        with self.hooks.call(idx):
            try:
                if self.kind == "single":
                    results = [run_pipeline(self.jobs / f"song{idx[0]:02d}", picked[0].path, device=self.device,
                                            settings=self.settings)]
                    job_dirs = [self.jobs / f"song{idx[0]:02d}"]
                else:
                    results = transcribe_batch([s.path for s in picked], self.jobs, device=self.device, settings=self.settings)
                    job_dirs = [self.jobs / "jobs" / s.path.stem for s in picked]
            except Exception as exc:  # a failed call counts its songs as failed
                error, results, job_dirs = f"{type(exc).__name__}: {exc}", [], []
        wall = time.perf_counter() - t0
        with record_function("harness") if record and self.hooks.trace else contextlib.nullcontext():
            done = []
            for j, s in enumerate(picked):
                res = results[j] if j < len(results) else None
                err = error or (res.transcription_error if res is not None else "no result")
                job = job_dirs[j] if j < len(job_dirs) else None
                profile = _read_profile(job) if (record and self.hooks.trace and job is not None) else None
                if record and s.index in self.hooks.want and s.index not in self.results and res is not None:
                    self.results[s.index] = {"result": res.to_dict(), "beats": _beats(job)}
                done.append(Done(s, wall, err, profile))
            for job in set(job_dirs) | ({self.jobs / "jobs"} if self.kind == "batch" else set()):
                shutil.rmtree(job, ignore_errors=True)
        return done

    def warm_up(self) -> None:
        """A cold call and a warm one on the first songs, outside the window."""
        for _ in range(2):
            self._next = 0
            self._call(record=False)
        self._next = 0

    def window(self, seconds: float) -> tuple[list[Done], float]:
        self.hooks.recording = True
        done = []
        t0 = time.perf_counter()
        with record_function("window") if self.hooks.trace else contextlib.nullcontext():
            while time.perf_counter() - t0 < seconds:
                # a sampled song is kept from its first call in the window
                self.hooks.want -= set(self.results)
                done += self._call(record=True)
        window_s = time.perf_counter() - t0
        self.hooks.recording = False
        return done, window_s
