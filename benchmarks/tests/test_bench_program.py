"""CPU tests of what the benchmark reads from the program's own tracer
(``core/program.py``, the ``tab_ms``, ``strum_ms`` and ``const_uploads``
readers, ``program_trace.py``): synthetic spans, counts and Chrome traces.

    python -m pytest benchmarks/tests -q
"""

import json
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(BENCH), str(BENCH.parent)]

import program_trace  # noqa: E402
from core import cells, program, trace  # noqa: E402
from core.drive import Done  # noqa: E402

from audiotabs_tpu_torch.tracing import request, span  # noqa: E402

READERS = {"tab_ms": "quantize/tab", "strum_ms": "mode/strum", "const_uploads": "const_uploads"}


class Run:
    def __init__(self, songs: int):
        self.done = [Done(song=None, wall_s=0.3, error=None) for _ in range(songs)]


def kept_spans() -> list:
    """Two requests' spans as the tracer keeps them: 3 + 5 ms of ``quantize/tab``, 2 ms of ``mode/strum``."""
    out = []
    for job, tab_ms in (("a", 3), ("b", 5)):
        with request(job) as req:
            with span("quantize") as q, span("quantize/tab") as t:
                pass
            t.start_ns, t.end_ns = 0, tab_ms * 1_000_000
            out += [t, q]
        out.append(req)
    with request("a"), span("mode/strum") as s:
        pass
    s.start_ns, s.end_ns = 10, 10 + 2_000_000
    return out + [s]


def test_readers_read_the_kept_spans_and_counts(monkeypatch):
    monkeypatch.setattr(program, "recorded", lambda: (kept_spans(), {"const_uploads": 54, "song_uploads": 2}))
    got = {name: cells.reader(name)(Run(2)) for name in READERS}
    assert got == {"tab_ms": pytest.approx(4.0), "strum_ms": pytest.approx(1.0), "const_uploads": 27.0}


@pytest.mark.parametrize("name", sorted(READERS))
@pytest.mark.parametrize("kept", [None, ([], {}), "other"])
def test_readers_give_nothing_without_their_span_or_counter(monkeypatch, name, kept):
    if kept == "other":  # spans and counts, none of this reader's
        kept = ([s for s in kept_spans() if s.name != READERS[name]], {"song_uploads": 2})
    monkeypatch.setattr(program, "recorded", lambda: kept)
    assert cells.reader(name)(Run(2)) is None


def test_readers_give_nothing_without_songs(monkeypatch):
    monkeypatch.setattr(program, "recorded", lambda: (kept_spans(), {"const_uploads": 54}))
    assert all(cells.reader(name)(Run(0)) is None for name in READERS)


def test_a_program_without_the_tracer_keeps_nothing(monkeypatch):
    monkeypatch.setitem(sys.modules, "audiotabs_tpu_torch.tracing", None)  # import then fails
    assert program.recorded() is None


@pytest.mark.parametrize("spans, device, idle", [
    ([(0, 100)], [], 100),
    ([(0, 100)], [("k", -10, 10), ("k", 90, 120)], 80),  # intervals across both edges
    ([(0, 100)], [("k", -10, 10), ("k", 5, 30), ("k", 50, 60)], 60),  # overlapping intervals count once
    ([(0, 100), (50, 150), (200, 210)], [("k", 140, 205)], 140 + 5),  # overlapping spans count once
    ([(0, 10), (20, 30)], [("k", 5, 25)], 10),  # one interval across two spans
    ([(0, 100)], [("k", 200, 300)], 100),
])
def test_idle_inside_spans(spans, device, idle):
    assert program.idle_inside(spans, device) == pytest.approx(idle)


class FakeProfiler:
    def __init__(self, events):
        self.events = events

    def export_chrome_trace(self, path):
        Path(path).write_text(json.dumps({"traceEvents": self.events}))


def chrome_events(with_program: bool) -> list:
    def x(cat, name, ts, dur):
        return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}

    events = [x("user_annotation", "window", 0, 1000), x("user_annotation", "fused", 100, 300),
              x("user_annotation", "host_tail", 450, 500), x("kernel", "median_k", 150, 50),
              x("gpu_memcpy", "Memcpy HtoD (Pageable)", 120, 10), x("kernel", "dbn_viterbi", 300, 80)]
    if with_program:
        events += [x("user_annotation", "audiotabs/request", 50, 920), x("user_annotation", "audiotabs/analysis", 90, 330),
                   x("user_annotation", "audiotabs/fused/nets", 110, 100), x("user_annotation", "audiotabs/quantize/tab", 600, 40)]
    return events


def test_program_spans_leave_the_benchmarks_trace_reading_as_it_was(tmp_path):
    plain = trace.read(FakeProfiler(chrome_events(False)), tmp_path / "a.json")
    both = trace.read(FakeProfiler(chrome_events(True)), tmp_path / "b.json")
    assert (both.spans, both.device, both.window) == (plain.spans, plain.device, plain.window)
    assert trace.breakdown(both) == trace.breakdown(plain) and trace.busy_s(both) == trace.busy_s(plain)


def test_program_trace_reads_the_program_spans(tmp_path):
    path = tmp_path / "t.json"
    FakeProfiler(chrome_events(True)).export_chrome_trace(path)
    device, spans, bench, window, htod_bytes, skew = program_trace.read_chrome(path)
    assert window == (0, 1000) and [n for n, *_ in bench] == ["fused", "host_tail"]
    assert [n for n, *_ in spans] == ["request", "analysis", "fused/nets", "quantize/tab"]
    assert program_trace.innermost(spans, [125, 700, 20]) == ["fused/nets", "request", "none"]
    assert program_trace.crossings(spans, bench) == []
    crossed = program_trace.crossings(spans + [("mode", 430, 460)], bench)
    assert crossed == [("mode", "host_tail", 430, 460, 450, 950)]
