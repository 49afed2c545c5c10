"""The port's tracer (``audiotabs_tpu_torch/tracing.py``) on the CPU.

Spans nest per thread, carry their parent and their request's id, and add
their seconds only to the ``stages`` dict they are given; ``profile.json`` of
a ``run_pipeline`` holds exactly its stages. Under a ``torch.profiler`` the
spans land in the Chrome trace as ``audiotabs/...`` user annotations inside
``audiotabs/request`` and are kept with the counts made meanwhile; without
one no profiler call is made. ``uploaded`` counts copies off the CPU only.
"""

from __future__ import annotations

import json
import threading
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from audiotabs_tpu_torch.config import Settings
from audiotabs_tpu_torch.io.wav import read_wav, write_wav
from audiotabs_tpu_torch import tracing
from audiotabs_tpu_torch.tracing import count, counters, recorded, request, span, traced, uploaded

CLIP = Path(__file__).parent / "data" / "heldout" / "heldout_strum_band.wav"
CROP = Settings(ENABLE_DEMUCS=False, PAD_SECONDS_BUCKET=6.0)
# the stages of a run_pipeline with ENABLE_DEMUCS=False, in the order they end
STAGES = ["decode", "analysis", "beats", "calibration", "transcription", "beat_select", "chords", "key", "mode",
          "quantize", "artifacts", "export"]


@pytest.fixture(scope="module", autouse=True)
def torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _no_profiler_calls(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("record_function entered with no profiler recording")

    monkeypatch.setattr(tracing, "record_function", refuse)


def test_spans_nest_with_parents_and_the_request_id():
    stages: dict[str, float] = {}
    with request("job-1") as req:
        with span("analysis", stages) as stage:
            with span("analysis/fused") as child:
                pass
        with span("export", stages):
            pass
    with span("outside") as alone:
        pass
    assert (stage.parent, child.parent, req.parent, alone.parent) == (req, stage, None, None)
    assert (req.request, stage.request, child.request, alone.request) == ("job-1", "job-1", "job-1", None)
    assert list(stages) == ["analysis", "export"]
    assert stages["analysis"] == pytest.approx(stage.seconds)
    assert req.start_ns <= stage.start_ns <= child.start_ns <= child.end_ns <= stage.end_ns <= req.end_ns
    assert tracing._stack() == []


def test_a_stage_entered_twice_adds_its_seconds():
    stages: dict[str, float] = {}
    with span("mode", stages) as a:
        pass
    with span("mode", stages) as b:
        pass
    assert stages == {"mode": pytest.approx(a.seconds + b.seconds)}


def test_each_thread_nests_its_own_spans():
    seen = {}

    def worker(job):
        with request(job):
            with span("beats") as s:
                seen[job] = s

    threads = [threading.Thread(target=worker, args=(f"job-{i}",)) for i in range(4)]
    with span("batch"):
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    assert {j: (s.request, s.parent.name, s.parent.parent) for j, s in seen.items()} == {
        f"job-{i}": (f"job-{i}", "request", None) for i in range(4)}


def test_a_span_ends_on_an_exception():
    stages: dict[str, float] = {}
    with pytest.raises(ValueError):
        with span("chords", stages):
            raise ValueError("boom")
    assert list(stages) == ["chords"] and tracing._stack() == []


def test_no_profiler_call_without_a_recording_profiler(monkeypatch):
    _no_profiler_calls(monkeypatch)
    spans_before, counts_before = recorded()

    @traced("mode/strum")
    def work(x):
        return x + 1

    with request("job"), span("mode", {}):
        assert work(1) == 2
        count("const_uploads")
    assert recorded() == (spans_before, counts_before)


@pytest.mark.parametrize("device, counted", [("meta", True), ("cpu", False)])
def test_as_device_counts_uploads_off_the_cpu(device, counted):
    from audiotabs_tpu_torch.ops.spectral import as_device

    a = np.arange(12, dtype=np.float32).reshape(3, 4)
    before = counters()
    t = as_device(a, torch.empty(1, device=device))
    after = counters()
    assert t.device.type == device and tuple(t.shape) == (3, 4)
    grew = {k: after.get(k, 0) - before.get(k, 0) for k in ("const_uploads", "const_upload_bytes", "song_uploads")}
    assert grew == ({"const_uploads": 1, "const_upload_bytes": 48, "song_uploads": 0} if counted
                    else {"const_uploads": 0, "const_upload_bytes": 0, "song_uploads": 0})


def test_counts_made_under_a_profiler_are_kept():
    before = recorded()[1].get("song_uploads", 0)
    uploaded(torch.empty(2, device="meta"), "song")  # not recording: counted, not kept
    with profile(activities=[ProfilerActivity.CPU]):
        uploaded(torch.empty(5, dtype=torch.float64, device="meta"), "song")
    kept = recorded()[1]
    assert kept["song_uploads"] - before == 1
    assert counters()["song_upload_bytes"] >= 40


@pytest.fixture(scope="module")
def pipeline_runs(tmp_path_factory):
    """One ``run_pipeline`` on a 5 s crop with no profiler (record_function
    refused) and one under a CPU profiler → {"plain" | "traced": (profile.json,
    Chrome trace events or None, the spans kept)}."""
    from audiotabs_tpu_torch.runtime.pipeline import run_pipeline

    root = tmp_path_factory.mktemp("tracing")
    x, sr = read_wav(CLIP)
    clip = root / "crop.wav"
    write_wav(clip, x[3 * sr : 8 * sr], sr)
    runs = {}
    with pytest.MonkeyPatch.context() as mp:
        _no_profiler_calls(mp)
        n_kept = len(recorded()[0])
        run_pipeline(root / "plain", clip, device="cpu", settings=CROP)
        assert len(recorded()[0]) == n_kept
    runs["plain"] = (json.loads((root / "plain" / "out" / "profile.json").read_text()), None, [])
    n_kept = len(recorded()[0])
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        run_pipeline(root / "traced", clip, device="cpu", settings=CROP)
    prof.export_chrome_trace(str(root / "trace.json"))
    events = json.loads((root / "trace.json").read_text())["traceEvents"]
    runs["traced"] = (json.loads((root / "traced" / "out" / "profile.json").read_text()), events, recorded()[0][n_kept:])
    return runs


@pytest.mark.parametrize("run", ["plain", "traced"])
def test_profile_json_holds_exactly_the_stages(pipeline_runs, run):
    prof = pipeline_runs[run][0]
    assert list(prof) == STAGES
    assert all(isinstance(v, float) and v >= 0 for v in prof.values())


def test_profiler_trace_holds_the_spans_inside_the_request(pipeline_runs):
    prof, events, kept = pipeline_runs["traced"]
    ours = [e for e in events if e.get("ph") == "X" and e.get("cat") == "user_annotation"
            and e["name"].startswith(tracing.PREFIX)]
    names = {e["name"] for e in ours}
    assert {"audiotabs/request", "audiotabs/analysis/fused", "audiotabs/analysis/transfer", "audiotabs/fused/nets",
            "audiotabs/quantize/tab", "audiotabs/transcription/notes", "audiotabs/mode/content", "audiotabs/export/musicxml",
            "audiotabs/export/lilypond"} <= names
    assert {f"audiotabs/{s}" for s in STAGES} <= names
    (req,) = [e for e in ours if e["name"] == "audiotabs/request"]
    lo, hi = req["ts"], req["ts"] + req["dur"]
    assert all(lo <= e["ts"] and e["ts"] + e["dur"] <= hi for e in ours)
    # the spans kept are the trace's, with the request's id and their stages' seconds
    assert sorted(tracing.PREFIX + s.name for s in kept) == sorted(e["name"] for e in ours)
    assert {s.request for s in kept} == {"traced"}
    top = {s.name: s.seconds for s in kept if s.parent is not None and s.parent.name == "request"}
    assert {k: round(top[k], 4) for k in STAGES} == prof


def test_batch_runner_spans_and_log_line(tmp_path, caplog):
    from audiotabs_tpu_torch.runtime.batch_runner import transcribe_batch

    x, sr = read_wav(CLIP)
    clips = []
    for i, start in enumerate((3, 9)):
        clips.append(tmp_path / f"crop{i}.wav")
        write_wav(clips[-1], x[start * sr : (start + 4) * sr], sr)
    n_kept = len(recorded()[0])
    with caplog.at_level("INFO", logger="audiotabs_tpu_torch.runtime.batch_runner"):
        with profile(activities=[ProfilerActivity.CPU]):
            results = transcribe_batch(clips, tmp_path / "out", device="cpu",
                                       settings=Settings(ENABLE_DEMUCS=False, PAD_SECONDS_BUCKET=6.0))
    assert [r.transcription_error for r in results] == [None, None]
    kept = {s.name: s for s in recorded()[0][n_kept:]}  # the pool's tails run on threads the profiler did not start in
    assert {"batch", "batch/load", "batch/dispatch", "batch/chunk", "batch/drain", "fused/nets"} <= set(kept)
    assert "request" not in kept
    whole = kept["batch"]
    assert all(kept[n].parent is whole for n in ("batch/load", "batch/dispatch", "batch/chunk", "batch/drain"))
    assert kept["fused/nets"].parent is kept["batch/dispatch"]
    (line,) = [r.getMessage() for r in caplog.records if r.getMessage().startswith("batch: 2 songs")]
    assert f"in {whole.seconds:.2f}s (load {kept['batch/load'].seconds:.2f}," in line
    for job in ("crop0", "crop1"):
        assert list(json.loads((tmp_path / "out" / "jobs" / job / "out" / "profile.json").read_text())) == STAGES[2:]
