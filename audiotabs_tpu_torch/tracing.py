"""The port's tracer: named spans and process-wide counters.

    with request(job_id):                      # one song's request
        with span("decode", stages):           # a stage: its seconds go into ``stages``
            ...
        with span("analysis/fused"):           # a child span: timed, added to nothing
            ...
    count("const_uploads")

A span records its name, its start and end (``time.perf_counter_ns``), the
span it opened in and the id of its request (the job id of the innermost
``request`` span of its thread). Spans nest per thread. A span given a
``stages`` dict adds its seconds there under its name: the pipeline gives
one dict a request to its top-level stages only, and writes that dict as
``profile.json``.

While a ``torch.profiler`` records on the span's thread, the span also opens
``record_function("audiotabs/<name>")``, so it lands in the profiler's
Chrome trace as a ``user_annotation`` on the device trace's clock, and is
kept with the counts made meanwhile (``recorded()``). A profiler that records
is the only switch: without one, a span costs a profiler-state check and two
clock reads, and no profiler call is made. The profiler's state is per
thread, so spans in a thread the profiler did not start in (the batch
runner's pool) are timed and not kept.

``count(name, n)`` adds to a process-wide counter; ``counters()`` returns a
snapshot. ``uploaded`` counts a host→device copy: ``const_uploads`` and
``const_upload_bytes`` for a constant (a window, a filterbank, a grid),
``song_uploads`` and ``song_upload_bytes`` for the song's own signal.
"""

from __future__ import annotations

import collections
import functools
import threading
import time

import torch
from torch.autograd.profiler import record_function

PREFIX = "audiotabs/"
KEPT = 200_000  # the most recorded spans kept; a 51 s window of 20-30 s clips records about 5,000

_local = threading.local()
_lock = threading.Lock()
_counts: collections.Counter = collections.Counter()
_recorded_spans: collections.deque = collections.deque(maxlen=KEPT)
_recorded_counts: collections.Counter = collections.Counter()


def _stack() -> list:
    try:
        return _local.stack
    except AttributeError:
        _local.stack = []
        return _local.stack


class span:
    """A timed block: ``with span(name, stages) as s: ...``; ``s.seconds`` after it."""

    __slots__ = ("name", "parent", "request", "start_ns", "end_ns", "_stages", "_annotation")

    def __init__(self, name: str, stages: dict[str, float] | None = None, *, request: str | None = None):
        self.name, self._stages, self.request = name, stages, request
        self.parent: span | None = None
        self.start_ns = self.end_ns = 0
        self._annotation = None

    def __enter__(self) -> span:
        stack = _stack()
        if stack:
            self.parent = stack[-1]
            if self.request is None:
                self.request = self.parent.request
        stack.append(self)
        if torch.autograd._profiler_enabled():
            self._annotation = record_function(PREFIX + self.name)
            self._annotation.__enter__()
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        self.end_ns = time.perf_counter_ns()
        if self._annotation is not None:
            self._annotation.__exit__(*exc)
            with _lock:
                _recorded_spans.append(self)
        _stack().pop()
        if self._stages is not None:
            self._stages[self.name] = self._stages.get(self.name, 0.0) + self.seconds
        return False

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9


def request(job_id: str) -> span:
    """The span of one request: every span opened inside it on its thread carries ``job_id``."""
    return span("request", request=job_id)


def traced(name: str):
    """A function's every call as a span ``name``."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return inner
    return wrap


def count(name: str, n: int = 1) -> None:
    recording = torch.autograd._profiler_enabled()
    with _lock:
        _counts[name] += n
        if recording:
            _recorded_counts[name] += n


def uploaded(t: torch.Tensor, what: str = "const") -> torch.Tensor:
    """``t``, just copied from host memory: one ``<what>_uploads`` and its
    bytes in ``<what>_upload_bytes`` where it landed off the CPU. Returns ``t``."""
    if t.device.type != "cpu":
        count(f"{what}_uploads")
        count(f"{what}_upload_bytes", t.numel() * t.element_size())
    return t


def counters() -> dict[str, int]:
    with _lock:
        return dict(_counts)


def recorded() -> tuple[list[span], dict[str, int]]:
    """(the spans that ended, the counts made) while a profiler recorded on
    their thread, since the process started: in a process that profiles one
    window, that window's."""
    with _lock:
        return list(_recorded_spans), dict(_recorded_counts)
