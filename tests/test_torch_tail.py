"""The port's host-tail modules against the JAX package's, module by module.

Seeded numpy inputs go through the JAX function and the port's; the host
code is a copy with its arithmetic unchanged, so every output must be equal
exactly: the same values of the same Python and numpy types (``_canon``),
and byte-equal files from the exporters. Schema objects are compared as
dumps (pydantic's ``model_dump()`` against the dataclasses' ``to_dict()``).
"""

from __future__ import annotations

import dataclasses
import enum
import json
import math
from pathlib import Path

import numpy as np
import pytest

from audiotabs_tpu import schemas as J
from audiotabs_tpu_torch import schemas as P
from test_torch_fused import torch_threads  # noqa: F401 (an autouse fixture: two intra-op threads)

SR = 22050
NATIVE_SR = 44100


def _canon(x):
    """A comparable form of an output: schema objects dumped, dataclasses as
    field dicts, arrays and numpy scalars tagged with their dtype."""
    if hasattr(x, "model_dump"):
        return _canon(x.model_dump())
    if isinstance(x, P._Schema):
        return _canon(x.to_dict())
    if dataclasses.is_dataclass(x):
        return {f.name: _canon(getattr(x, f.name)) for f in dataclasses.fields(x)}
    if isinstance(x, enum.Enum):
        return x.value
    if isinstance(x, np.ndarray):
        return ("ndarray", str(x.dtype), x.shape, _canon(x.tolist()))
    if isinstance(x, np.generic):
        return (str(x.dtype), _canon(x.item()))
    if isinstance(x, (list, tuple)):
        return [_canon(v) for v in x]
    if isinstance(x, dict):
        return {k: _canon(v) for k, v in x.items()}
    if isinstance(x, float) and math.isnan(x):
        return "nan"
    return x


def _same(a, b):
    assert _canon(a) == _canon(b)


def _port(obj):
    """A JAX-package schema object (or a list of them) as the port's."""
    if isinstance(obj, list):
        return [_port(o) for o in obj]
    return getattr(P, type(obj).__name__)(**obj.model_dump())


def _events(rng, n: int, dur: float = 8.0):
    from audiotabs_tpu.theory.events import NoteEvent as JN
    from audiotabs_tpu_torch.theory.events import NoteEvent as PN

    rows = []
    for _ in range(n):
        t0 = float(rng.uniform(0.0, dur))
        rows.append((t0, t0 + float(rng.uniform(0.06, 1.2)), int(rng.integers(40, 84)), int(rng.integers(30, 127)), float(rng.uniform(0.05, 1.0))))
    rows.sort()
    return [JN(*r) for r in rows], [PN(*r) for r in rows]


def _chords(rng, n: int, labels=("G:maj", "D:maj", "A:min", "C:maj", "E:min7", "B:7", "F#:min", "N", "D:maj7")):
    bounds = np.cumsum(rng.uniform(0.3, 3.0, n + 1))
    js = [
        J.ChordSegment(start=float(bounds[i]), end=float(bounds[i + 1]), label=str(rng.choice(labels)), confidence=float(rng.uniform(0.0, 1.0)))
        for i in range(n)
    ]
    return js, _port(js)


def _beats(rng, n: int = 24, period: float = 0.5, jitter: float = 0.02, start: float = 0.3):
    return (start + period * np.arange(n) + rng.normal(0, jitter, n)).astype(np.float32)


def _strums(sr: int, dur: float, period: float = 0.25, seed: int = 1) -> np.ndarray:
    """Repeated percussive strums of one chord with noise attacks."""
    rng = np.random.default_rng(seed)
    n = int(sr * dur)
    y = np.zeros(n, dtype=np.float32)
    p = int(period * sr)
    for start in range(0, n - p, p):
        t = np.arange(p) / sr
        burst = sum(0.2 * np.sin(2 * np.pi * 440.0 * 2 ** ((m - 69) / 12) * t) for m in (48, 52, 55)) * np.exp(-t * 12)
        burst[: sr // 100] += 0.4 * rng.standard_normal(sr // 100)
        y[start : start + p] += burst.astype(np.float32)
    return y


# ---------------------------------------------------------------- schemas --


def test_schemas_coerce_and_dump_as_pydantic():
    kw = dict(tonic="G", mode="major", fifths=np.int64(1), name="G major", vexflow="G", use_flats=False, score=np.float32(0.7))
    item = dict(keys=("g/3", "b/3"), duration="8", dots=np.int64(1), tuplet={"num_notes": 3, "notes_occupied": 2}, tie="start")
    score = dict(grid_q=np.float32(0.25), grid_kind="straight", measures=[dict(number=np.int64(1), items=[item, dict(rest=True, duration="q")])])
    chords = [dict(start=np.float32(0.1), end=2, label=np.str_("G:maj"), confidence=np.float64(0.5))]
    args = dict(job_id="job", tempo_bpm=np.float32(68.5), time_signature="3/4", key_signature=kw, chords=chords, transcription_backend="guitar_hybrid", score=score)
    ref = J.JobResult(**args)
    got = P.JobResult(**args)
    assert json.loads(got.to_json()) == json.loads(ref.model_dump_json())
    assert got.to_dict() == ref.model_dump()
    _same(ref, got)
    assert type(got.chords[0].end) is float and type(got.key_signature.fifths) is int and type(got.score.grid_q) is float
    empty = dict(job_id="j", tempo_bpm=120, time_signature="4/4")
    assert json.loads(P.JobResult(**empty).to_json()) == json.loads(J.JobResult(**empty).model_dump_json())
    with pytest.raises(ValueError):
        P.TupletSpec(num_notes=2.5, notes_occupied=2)


# --------------------------------------------------------- note decoding --

FPS = SR / 256
MIDI_A0 = 21
GAP = 3  # notes_from_posteriors' gap_tolerance_frames


def _f16(*arrays):
    """Rounded through f16, as the fused outputs are."""
    return tuple(np.asarray(a).astype(np.float16).astype(np.float32) for a in arrays)


def _walks(rng, T):
    """Smooth posteriors with plateaus around the thresholds: most bins near them."""
    frame = np.clip(np.cumsum(rng.normal(0, 0.08, (T, 88)), axis=0) * 0.2 + rng.uniform(0, 0.45, (1, 88)), 0, 1)
    onset = np.where(rng.random((T, 88)) < 0.02, rng.uniform(0.2, 1.0, (T, 88)), 0.1 * rng.random((T, 88)))
    return _f16(onset, frame)


def _sparse(rng, T, levels=None):
    """A few % of the bins on: notes of 3-120 frames, most with an onset, leaking into the
    semitones beside them, over a floor of noise; ``levels`` quantises the frame posterior to
    that many steps, so equal values tie across pitches and frames."""
    frame = rng.uniform(0, 0.12, (T, 88))
    onset = rng.uniform(0, 0.15, (T, 88))
    for _ in range(int(0.03 * T * 88 / 40)):
        p, t, d = rng.integers(0, 88), rng.integers(0, T), rng.integers(3, 120)
        seg = rng.uniform(0.2, 1.0) * (1 - 0.4 * rng.random(min(d, T - t)))
        frame[t : t + d, p] = np.maximum(frame[t : t + d, p], seg)
        if rng.random() < 0.7:
            onset[t, p] = rng.uniform(0.3, 1.0)
        for q in (p - 1, p + 1):
            if 0 <= q < 88 and rng.random() < 0.5:
                frame[t : t + d, q] = np.maximum(frame[t : t + d, q], seg * rng.uniform(0.2, 0.8))
    if levels:
        frame = np.round(frame * levels) / levels
    return _f16(onset, np.clip(frame, 0, 1))


def _edges(rng, T):
    """Notes that run to the last frame, off runs of exactly GAP frames inside notes and of GAP + 1
    that end them, and onset-less notes whose walk back lands on a peak note's start frame."""
    onset, frame = _sparse(rng, T)
    frame, onset = frame * 0.5, onset * 0.5
    for i, p in enumerate(range(5, 80, 6)):
        t = int(rng.integers(T // 2, T - 40))
        frame[t:, p] = 0.9  # to the last frame
        onset[t, p] = 0.9 if i % 3 else 0.1  # some with an onset, some seeded
        g = t + 10
        frame[g : g + GAP, p] = 0.05  # tolerated
        frame[g + GAP + 8 : g + 2 * GAP + 9, p] = 0.05 if i % 2 else 0.9  # GAP + 1: the note ends there
        s = int(rng.integers(GAP + 2, T // 2 - 40))
        frame[s - GAP - 1 : s + 30, p + 1 : p + 3] = 0.0
        frame[s : s + 30, p + 1] = 0.8  # an onset: the peak pass
        onset[s, p + 1] = 0.95
        frame[s : s + 30, p + 2] = 0.7  # no onset: a seed walks back to s
        frame[s + 12, p + 2] = 0.75
    frame[-GAP:, 2] = 0.0
    frame[-GAP - 20 : -GAP, 2] = 0.9  # an off run of GAP frames at the end
    return onset, frame


def _nan(rng, T, inside):
    """NaN in the frame posterior: inside a note (its mean is NaN: the velocity raises), or as
    seeds taken before every number: one among off frames, which makes no note, and one just past
    a quiet onset-less note, which seeds it before a louder one that starts on the same frame."""
    onset, frame = _sparse(rng, T)
    if inside:
        p = int(np.argmax(frame.max(axis=0)))
        t = int(np.argmax(frame[:, p]))
        frame[t + 1, p] = np.nan
        return onset, frame
    frame[T // 3 - 20 : T // 3 + 20, 40] = 0.0
    frame[T // 3, 40] = np.nan
    s = T // 2
    for p in (59, 60, 61, 69, 70, 71):
        frame[s - GAP - 1 : s + 60, p] = 0.0
        onset[s - GAP - 1 : s + 60, p] = 0.0
    frame[s : s + 20, 60] = 0.5
    frame[s + 20, 60] = np.nan
    frame[s : s + 30, 70] = 0.9
    return onset, frame


# (onset, frame) thresholds that the pipeline's calibration gave the benchmark's songs on the
# card: a 180 s song of ``shipped``, a clip of ``mix``
SONG = (0.2820666732788086, 0.24)
CLIP = (0.4221331740349126, 0.37303623059632507)
NOTE_CASES = [
    pytest.param("walks", 0, 430, 0.5, 0.3, True, id="0-0.5-0.3-True"),
    pytest.param("walks", 1, 430, 0.4, 0.25, True, id="1-0.4-0.25-True"),
    pytest.param("walks", 2, 430, 0.62, 0.41, False, id="2-0.62-0.41-False"),
    pytest.param("walks", 3, 430, 0.25, 0.15, True, id="3-0.25-0.15-True"),
    pytest.param("sparse", 4, 2584, *SONG, True, id="sparse-2584-song"),
    pytest.param("sparse", 5, 2584, *CLIP, True, id="sparse-2584-clip"),
    pytest.param("sparse", 6, 15504, *SONG, True, id="sparse-15504-song"),
    pytest.param("sparse", 7, 15504, *CLIP, True, id="sparse-15504-clip"),
    pytest.param("plateaus", 8, 2584, *SONG, True, id="plateaus-2584"),
    pytest.param("plateaus", 9, 430, 0.5, 0.3, True, id="plateaus-430"),
    pytest.param("edges", 10, 2584, *CLIP, True, id="edges-2584"),
    pytest.param("edges", 11, 430, 0.5, 0.3, False, id="edges-430-no-melodia"),
    pytest.param("sparse", 12, 2584, *SONG, False, id="sparse-2584-no-melodia"),
    pytest.param("silent", 13, 430, 0.5, 0.3, True, id="no-event"),
    pytest.param("nan-inside", 14, 2584, *SONG, True, id="nan-inside-a-note"),
    pytest.param("nan-seeds", 15, 2584, *CLIP, True, id="nan-seeds"),
]


def _posteriors(kind, seed, T):
    rng = np.random.default_rng(seed)
    if kind == "walks":
        return _walks(rng, T)
    if kind == "sparse":
        return _sparse(rng, T)
    if kind == "plateaus":
        return _sparse(rng, T, levels=4)
    if kind == "edges":
        return _edges(rng, T)
    if kind == "silent":
        return _f16(rng.uniform(0, 0.2, (T, 88)), rng.uniform(0, 0.25, (T, 88)))
    return _nan(rng, T, inside=kind == "nan-inside")


def _outcome(fn, *args, **kw):
    """The events, or the exception's type and message."""
    try:
        return fn(*args, **kw)
    except Exception as exc:  # noqa: BLE001 (the exception is the outcome compared)
        return type(exc).__name__, str(exc)


@pytest.mark.parametrize("kind,seed,T,onset_thr,frame_thr,melodia", NOTE_CASES)
def test_notes_from_posteriors_matches_jax(kind, seed, T, onset_thr, frame_thr, melodia):
    """The same events in the same order, every field of the same value and type, or the same exception."""
    from audiotabs_tpu.models.basicpitch import notes_from_posteriors as jax_notes
    from audiotabs_tpu_torch.models.basicpitch import notes_from_posteriors

    onset, frame = _posteriors(kind, seed, T)
    kw = dict(fps=FPS, onset_threshold=onset_thr, frame_threshold=frame_thr, min_note_ms=127.7, melodia_trick=melodia)
    ref = _outcome(jax_notes, onset, frame, **kw)
    got = _outcome(notes_from_posteriors, onset, frame, **kw)
    if kind == "silent":
        assert ref == []
    elif kind == "nan-inside":
        assert ref == ("ValueError", "cannot convert float NaN to integer")
    else:
        assert len(ref) > 5
    _same(ref, got)
    if kind == "nan-seeds":  # the NaN's note first, the louder one after it
        same = [e.pitch_midi for e in ref if e.start_time_s == (T // 2) / FPS]
        assert same == [MIDI_A0 + 60, MIDI_A0 + 70]
    if kind == "edges":  # the cases it was built for occur: a note to the last frame, and with
        # the seeds a peak note and a seeded one that start on one frame
        assert any(e.end_time_s == T / FPS for e in ref)
        starts = [e.start_time_s for e in ref]
        assert len(starts) > len(set(starts)) or not melodia


@pytest.mark.parametrize("frame_thr", [0.0, -0.1, float("nan")])
def test_the_melodia_pass_refuses_a_threshold_that_cleared_frames_meet(frame_thr):
    """A cleared frame (0.0) would be taken as a seed again without end (the JAX package's loop
    never ends there), so the melodia pass raises; without it the onset pass decodes as the JAX
    package's does, cleared frames on where 0.0 meets the threshold."""
    from audiotabs_tpu.models.basicpitch import notes_from_posteriors as jax_notes
    from audiotabs_tpu_torch.models.basicpitch import notes_from_posteriors

    onset, frame = _posteriors("sparse", 24, 430)
    with pytest.raises(ValueError, match="frame_threshold > 0"):
        notes_from_posteriors(onset, frame, fps=FPS, frame_threshold=frame_thr)
    kw = dict(fps=FPS, frame_threshold=frame_thr, melodia_trick=False)
    _same(jax_notes(onset, frame, **kw), notes_from_posteriors(onset, frame, **kw))


def _old_loop_counts(onset, frame, **kw):
    """(events before the leakage rule, melodia seeds) of the JAX package's decoder: its
    NoteEvents made, and its argmax steps less the one that ends the loop."""
    import audiotabs_tpu.models.basicpitch as jbp

    made, steps = [], []
    real_event, real_argmax = jbp.NoteEvent, np.argmax
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jbp, "NoteEvent", lambda **f: made.append(real_event(**f)) or made[-1])
        mp.setattr(np, "argmax", lambda a, *args, **kws: steps.append(1) or real_argmax(a, *args, **kws))
        jbp.notes_from_posteriors(onset, frame, **kw)
    return len(made), len(steps) - 1


@pytest.mark.parametrize("kind,seed,melodia", [("sparse", 20, True), ("walks", 21, True), ("sparse", 22, False)])
def test_note_counters_count_the_old_loops_events_and_seeds(kind, seed, melodia):
    from audiotabs_tpu_torch import tracing
    from audiotabs_tpu_torch.models.basicpitch import notes_from_posteriors

    onset, frame = _posteriors(kind, seed, 2584)
    kw = dict(fps=FPS, onset_threshold=0.5, frame_threshold=0.3, min_note_ms=127.7, melodia_trick=melodia)
    events, seeds = _old_loop_counts(onset, frame, **kw)
    before = tracing.counters()
    notes_from_posteriors(onset, frame, **kw)
    after = tracing.counters()
    grew = {k: after.get(k, 0) - before.get(k, 0) for k in ("note_events", "note_seeds")}
    assert grew == {"note_events": events, "note_seeds": seeds if melodia else 0}
    assert events > 20 and (seeds > 20 if melodia else seeds == -1)


def test_the_benchmark_reads_the_kept_note_span(monkeypatch):
    """Under a profiler the span ``transcription/notes`` (the pipeline opens it around the
    decoder) and both counters are kept, and ``benchmarks/metrics/notes_ms.py`` reads the span a song."""
    from types import SimpleNamespace

    from torch.profiler import ProfilerActivity, profile

    from audiotabs_tpu_torch import tracing
    from audiotabs_tpu_torch.models.basicpitch import notes_from_posteriors

    monkeypatch.syspath_prepend(str(Path(__file__).resolve().parents[1] / "benchmarks"))
    from core import cells, program

    onset, frame = _posteriors("sparse", 23, 2584)
    n_spans, before = len(tracing.recorded()[0]), tracing.recorded()[1]
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(2):
            with tracing.span("transcription/notes"):
                notes_from_posteriors(onset, frame, fps=FPS)
    spans, after = tracing.recorded()
    kept = [s for s in spans[n_spans:] if s.name == "transcription/notes"]
    assert len(kept) == 2
    counts = {k: after[k] - before.get(k, 0) for k in ("note_events", "note_seeds")}
    assert counts["note_events"] > 0 and counts["note_seeds"] > 0
    monkeypatch.setattr(program, "recorded", lambda: (kept, counts))
    run = SimpleNamespace(done=[None, None, None])
    assert cells.reader("notes_ms")(run) == pytest.approx(sum(s.end_ns - s.start_ns for s in kept) / 1e6 / 3)
    monkeypatch.setattr(program, "recorded", lambda: ([], {"const_uploads": 3}))  # a program without it
    assert cells.reader("notes_ms")(run) is None


# ---------------------------------------------------- quantize, beat grid --


@pytest.mark.parametrize("seed,time_sig,with_beats", [(0, "4/4", True), (1, "3/4", True), (2, "4/4", False), (3, "6/8", True)])
def test_quantize_note_events_to_score_matches_jax(seed, time_sig, with_beats):
    from audiotabs_tpu.theory.quantize import quantize_note_events_to_score as jax_quantize
    from audiotabs_tpu_torch.theory.quantize import quantize_note_events_to_score

    rng = np.random.default_rng(seed)
    jev, pev = _events(rng, 40)
    beats = _beats(rng) - 0.3 if with_beats else None
    kw = dict(tempo_bpm=112.0, beat_times=beats, time_signature=time_sig, guitar_tuning="standard")
    ref = jax_quantize(jev, **kw)
    got = quantize_note_events_to_score(pev, **kw)
    assert ref.tab_positions and ref.score.measures
    _same(ref, got)


@pytest.mark.parametrize("seed,time_sig,period", [(0, "4/4", 0.5), (1, "3/4", 0.25), (2, "4/4", 1.1), (3, "4/4", 0.35)])
def test_pick_best_beat_times_matches_jax(seed, time_sig, period):
    from audiotabs_tpu.theory.chord_simplify import pick_best_beat_times as jax_pick
    from audiotabs_tpu.theory.chord_simplify import tempo_from_beat_times as jax_tempo
    from audiotabs_tpu_torch.theory.chord_simplify import pick_best_beat_times, tempo_from_beat_times

    rng = np.random.default_rng(seed)
    jev, pev = _events(rng, 300 if seed == 3 else 50)  # seed 3 takes the loudest-250 sample
    beats = _beats(rng, n=int(8 / period), period=period)
    ref = jax_pick(jev, beats, time_signature=time_sig)
    got = pick_best_beat_times(pev, beats, time_signature=time_sig)
    _same(ref, got)
    _same(jax_tempo(ref), tempo_from_beat_times(got))


@pytest.mark.parametrize("case", ["44_accented", "34_waltz", "random", "few_beats"])
def test_infer_meter_and_downbeats_matches_jax(case):
    from audiotabs_tpu.decode.downbeats import infer_meter_and_downbeats as jax_meter
    from audiotabs_tpu_torch.decode.downbeats import infer_meter_and_downbeats

    rng = np.random.default_rng(len(case))
    beats = np.arange(0.5, 12.0, 0.5)
    act = np.full(int(beats[-1] * 100) + 10, 0.05)
    accent = {"44_accented": 4, "34_waltz": 3}.get(case)
    for i, t in enumerate(beats):
        act[int(t * 100)] = 0.9 if accent and i % accent == 1 else (rng.uniform(0.2, 0.9) if case == "random" else 0.5)
    if case == "few_beats":
        beats = beats[:3]
    beats = beats.astype(np.float32)
    act = act.astype(np.float32)
    _same(jax_meter(beats, act, fps=100), infer_meter_and_downbeats(beats, act, fps=100))


@pytest.mark.parametrize("beats", [None, [], [np.nan, 1.0], [3.2, 0.4, 1.0, np.inf, 1.6], [0.0, 0.5]])
def test_normalize_beat_times_and_tempo_match_jax(beats):
    from audiotabs_tpu.decode.dbn_beats import estimate_tempo as jax_tempo
    from audiotabs_tpu.decode.dbn_beats import normalize_beat_times as jax_norm
    from audiotabs_tpu_torch.decode.dbn_beats import estimate_tempo, normalize_beat_times

    bt = None if beats is None else np.asarray(beats, dtype=np.float32)
    _same(jax_norm(bt), normalize_beat_times(bt))
    if bt is not None:
        _same(jax_tempo(bt), estimate_tempo(bt))


# ----------------------------------------------------------- chords, key --


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_simplify_chords_match_jax(seed):
    from audiotabs_tpu.theory.chord_simplify import simplify_chord_segments as jax_simplify
    from audiotabs_tpu.theory.chord_simplify import simplify_chords_for_accompaniment as jax_acc
    from audiotabs_tpu_torch.theory.chord_simplify import simplify_chord_segments, simplify_chords_for_accompaniment

    rng = np.random.default_rng(seed)
    jc, pc = _chords(rng, 14)
    times = np.arange(400, dtype=np.float32) / 10.0
    chroma = rng.random((12, 400)).astype(np.float32)
    kw = dict(chroma=chroma, times=times, min_confidence=0.02, min_duration=1.0, seventh_ratio=0.5)
    _same(jax_simplify(jc, **kw), simplify_chord_segments(pc, **kw))
    _same(jax_simplify(jc, chroma=None, times=None), simplify_chord_segments(pc, chroma=None, times=None))
    _same(jax_acc(jc), simplify_chords_for_accompaniment(pc))


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_key_from_probs_and_chords_matches_jax(seed):
    from audiotabs_tpu.models.key_cnn import key_prediction_to_label as jax_label
    from audiotabs_tpu.theory import key as jk
    from audiotabs_tpu_torch.models.key_cnn import key_prediction_to_label
    from audiotabs_tpu_torch.theory import key as pk
    from audiotabs_tpu_torch.theory.vocabulary import NOTE_TO_PC

    rng = np.random.default_rng(seed)
    jc, pc = _chords(rng, 10)
    probs = rng.dirichlet(np.full(24, 0.3)).astype(np.float32)
    ref = jk.rescore_key_with_chords(probs, jc)
    got = pk.rescore_key_with_chords(probs, pc)
    _same(ref, got)
    label = key_prediction_to_label(got)
    assert label == jax_label(ref)
    tonic, mode = label.split()
    _same(jk._make_estimate(NOTE_TO_PC[tonic], mode, float(ref.max())).to_schema(), pk._make_estimate(NOTE_TO_PC[tonic], mode, float(got.max())).to_schema())
    chroma = rng.random((12, 50)).astype(np.float32)
    _same(jk.estimate_key_from_chroma(chroma), pk.estimate_key_from_chroma(chroma))
    jev, pev = _events(rng, 30)
    _same(jk.estimate_key_from_events(jev), pk.estimate_key_from_events(pev))
    for c in pc:
        for flats in (False, True):
            assert pk.spell_chord_label(c.label, flats) == jk.spell_chord_label(c.label, flats)


# ------------------------------------------------- calibration, content --


@pytest.mark.parametrize("seed", range(4))
def test_calibrate_thresholds_matches_jax(seed):
    from audiotabs_tpu.analysis.audio_quality import _to_db as jax_db
    from audiotabs_tpu.analysis.audio_quality import calibrate_thresholds as jax_cal
    from audiotabs_tpu_torch.analysis.audio_quality import _to_db, calibrate_thresholds

    rng = np.random.default_rng(seed)
    rms = float(rng.uniform(0.0, 0.4))
    chars = {
        "rms_db": _to_db(rms), "spectral_centroid": float(rng.uniform(500, 4000)),
        "spectral_rolloff": float(rng.uniform(2000, 9000)), "harmonic_ratio": float(rng.uniform(0.3, 0.8)),
        "onset_density": float(rng.uniform(1.0, 10.0)), "noise_floor_db": _to_db(float(rng.uniform(0, 0.05))),
    }
    assert _to_db(rms) == jax_db(rms) and _to_db(0.0) == jax_db(0.0)
    _same(jax_cal(chars), calibrate_thresholds(chars))
    _same(jax_cal({}), calibrate_thresholds({}))


def _content_metrics(rng, n: int) -> tuple[np.ndarray, np.ndarray]:
    """Window starts and [W, 4] metrics that fall melodic, chordal and hybrid."""
    starts = (np.arange(n) * (SR + SR // 2)).astype(np.int32)
    kinds = rng.integers(0, 3, n)
    base = np.array([[6.0, 2.0, 0.2, 0.8], [1.0, 8.0, 0.6, 0.4], [3.0, 4.5, 0.3, 0.55]], dtype=np.float32)
    metrics = base[kinds] + rng.normal(0, 0.3, (n, 4)).astype(np.float32)
    return starts, metrics.astype(np.float32)


@pytest.mark.parametrize("seed,n", [(0, 9), (1, 20), (2, 1)])
def test_analyze_musical_content_precomputed_matches_jax(seed, n):
    from audiotabs_tpu.analysis.content_classifier import analyze_musical_content as jax_content
    from audiotabs_tpu_torch.analysis.content_classifier import analyze_musical_content

    rng = np.random.default_rng(seed)
    starts, metrics = _content_metrics(rng, n)
    y = np.zeros(int(starts[-1]) + 2 * SR, dtype=np.float32)
    ref = jax_content(y, SR, precomputed=(starts, metrics))
    got = analyze_musical_content(y, SR, precomputed=(starts, metrics))
    _same(ref, got)
    # without precomputed metrics, the windows' metrics on the device (the
    # CPU here): 4 s windows with a 2 s hop on 12 s of strums, and the
    # short-song branch on 2 s; the metrics are float32 of two libraries
    y = _strums(SR, 2.0 if n == 1 else 12.0, 0.25 + 0.05 * seed, seed=seed)
    ref = jax_content(y, SR, window_sec=4.0, hop_sec=2.0)
    got = analyze_musical_content(y, SR, window_sec=4.0, hop_sec=2.0, device="cpu")
    assert len(got) == len(ref) >= 1 and (n != 1 or len(ref) == 1)
    for a, b in zip(got, ref):
        assert (a.start_time_s, a.end_time_s, a.content_type, a.confidence, list(a.metrics)) == (
            b.start_time_s, b.end_time_s, b.content_type, b.confidence, list(b.metrics))
        np.testing.assert_allclose(list(a.metrics.values()), list(b.metrics.values()), rtol=1e-5)


# ------------------------------------------------------------------ strum --


@pytest.mark.parametrize("sr,period,use_beats", [(NATIVE_SR, 0.25, True), (NATIVE_SR, 0.4, False), (SR, 0.3, True)])
def test_detect_strum_onsets_host_envelope_matches_jax(sr, period, use_beats):
    from audiotabs_tpu.accompaniment.strum import _onset_strength_median_host as jax_env
    from audiotabs_tpu.accompaniment.strum import detect_strum_onsets as jax_detect
    from audiotabs_tpu_torch.accompaniment.strum import _onset_strength_median_host, detect_strum_onsets

    y = _strums(sr, 4.0, period, seed=int(period * 100))
    _same(jax_env(y, sr), _onset_strength_median_host(y, sr))
    beats = np.arange(0.0, 4.0, 0.5) if use_beats else None
    ref = jax_detect(y, sr, beat_times=beats, tempo_bpm=120.0)
    got = detect_strum_onsets(y, sr, beat_times=beats, tempo_bpm=120.0)
    assert len(ref) >= 4
    _same(ref, got)


@pytest.mark.parametrize("seed", [0, 1])
def test_detect_strum_onsets_given_envelope_matches_jax(seed):
    from audiotabs_tpu.accompaniment.strum import detect_strum_onsets as jax_detect
    from audiotabs_tpu_torch.accompaniment.strum import detect_strum_onsets

    rng = np.random.default_rng(seed)
    env = np.abs(rng.normal(0, 0.05, 300)).astype(np.float32)
    env[rng.choice(300, 40, replace=False)] += rng.uniform(0.2, 1.0, 40).astype(np.float32)
    y = np.zeros(300 * 512, dtype=np.float32)
    kw = dict(beat_times=None, tempo_bpm=96.0, envelope=env, min_interval_s=0.12 + 0.08 * seed, onset_delta=0.2 + 0.05 * seed)
    ref = jax_detect(y, SR, **kw)
    got = detect_strum_onsets(y, SR, **kw)
    assert len(ref) >= 4
    _same(ref, got)


# ------------------------------------------------------------------ modes --


def _mode_inputs(seed: int):
    rng = np.random.default_rng(seed)
    dur = 12.0
    y_nat = _strums(NATIVE_SR, dur, 0.25 + 0.05 * seed, seed=seed)
    y = y_nat[::2].copy()  # the 22.05 kHz stand-in for the harmonic stem
    jc, pc = _chords(rng, 6)
    beats = (0.25 + 0.5 * np.arange(int(dur / 0.5) - 1)).astype(np.float32)
    jev, pev = _events(rng, 40, dur)
    starts, metrics = _content_metrics(rng, 7)
    return y, y_nat, jc, pc, beats, jev, pev, (starts, metrics)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("native", [True, False])
def test_run_guitar_mode_matches_jax(seed, native):
    from audiotabs_tpu.runtime.modes import run_guitar_mode as jax_guitar
    from audiotabs_tpu_torch.accompaniment.strum import _onset_strength_median_host
    from audiotabs_tpu_torch.runtime.modes import run_guitar_mode

    y, y_nat, jc, pc, beats, jev, pev, content = _mode_inputs(seed)
    env = _onset_strength_median_host(y, SR)
    env = (env / (env.max() + 1e-9)).astype(np.float32)
    kw = dict(use_flats=bool(seed), precomputed_content=content, y_strum=(y_nat, NATIVE_SR) if native else None, strum_envelope=None if native else env)
    ref = jax_guitar(y, SR, jc, beats, 120.0, base_note_events=jev, **kw)
    got = run_guitar_mode(y, SR, pc, beats, 120.0, base_note_events=pev, **kw)
    assert ref.strum_onsets and ref.note_events and {c.content_type for c in ref.content_segments} >= {"melodic", "chordal"}
    _same(ref, got)


@pytest.mark.parametrize("seed,time_sig", [(0, "4/4"), (1, "3/4")])
def test_run_accompaniment_mode_matches_jax(seed, time_sig):
    from audiotabs_tpu.runtime.modes import run_accompaniment_mode as jax_acc
    from audiotabs_tpu.theory.chord_simplify import simplify_chords_for_accompaniment as jax_simplify
    from audiotabs_tpu_torch.runtime.modes import run_accompaniment_mode
    from audiotabs_tpu_torch.theory.chord_simplify import simplify_chords_for_accompaniment

    _y, y_nat, jc, pc, beats, _jev, _pev, _content = _mode_inputs(seed)
    ref = jax_acc(y_nat, NATIVE_SR, jax_simplify(jc), beats, 120.0, use_flats=bool(seed), time_signature=time_sig)
    got = run_accompaniment_mode(y_nat, NATIVE_SR, simplify_chords_for_accompaniment(pc), beats, 120.0, use_flats=bool(seed), time_signature=time_sig)
    assert ref.score_override.measures and ref.strum_onsets
    _same(ref, got)


def test_run_guitar_mode_without_base_events_is_not_ported(monkeypatch):
    """Guitar mode without the pipeline's base note events (the test keeps
    its name from before this was ported): it transcribes the signal itself
    on the device (the CPU here) with Basic Pitch, on the strums, or, when
    that fails, with the pYIN melody, on 12 s of the held-out picked melody.
    Notes by pitch and onset and offset (ms), amplitudes within rtol 1e-5;
    everything else equal.

    The melody tracker is not held on the strums: they are a C-E-G chord,
    whose pYIN track wanders around MIDI 52.5, and a last-bit difference of
    the two packages' f0 (2.6e-6 semitones) moves a run's rounded median or
    a split there (29 notes against 27; ROADMAP.md, section 3)."""
    import audiotabs_tpu.models.basicpitch as jax_bp
    import audiotabs_tpu_torch.models.basicpitch as bp
    from audiotabs_tpu.runtime.modes import run_guitar_mode as jax_guitar
    from audiotabs_tpu_torch.io.wav import decode_for_analysis
    from audiotabs_tpu_torch.runtime.modes import run_guitar_mode

    y, y_nat, jc, pc, beats, _jev, _pev, content = _mode_inputs(0)
    kw = dict(precomputed_content=content, y_strum=(y_nat, NATIVE_SR))
    for fallback in ("basic pitch", "melody"):
        if fallback == "melody":
            def fail(*args, **kwargs):
                raise RuntimeError("forced")

            monkeypatch.setattr(jax_bp, "transcribe_polyphonic", fail)
            monkeypatch.setattr(bp, "transcribe_polyphonic", fail)
            melody, _, _ = decode_for_analysis(Path(__file__).parent / "data" / "heldout" / "heldout_picked_melody.wav", SR)
            y = np.ascontiguousarray(melody[3 * SR : 15 * SR])
            kw = dict(precomputed_content=content)
        ref = jax_guitar(y, SR, jc, beats, 120.0, **kw)
        got = run_guitar_mode(y, SR, pc, beats, 120.0, device="cpu", **kw)
        assert len(ref.note_events) > 5 and (ref.strum_onsets or fallback == "melody")
        notes = [(e.pitch_midi, round(e.start_time_s * 1000), round(e.end_time_s * 1000)) for e in got.note_events]
        assert notes == [(e.pitch_midi, round(e.start_time_s * 1000), round(e.end_time_s * 1000)) for e in ref.note_events]
        np.testing.assert_allclose([e.amplitude for e in got.note_events], [e.amplitude for e in ref.note_events], rtol=1e-5)
        _same(dataclasses.replace(ref, note_events=[]), dataclasses.replace(got, note_events=[]))


# -------------------------------------------------------------- exporters --


def _score_case(seed: int, accompaniment: bool):
    """A score, its tab positions and chords from the JAX quantiser or the strum path."""
    rng = np.random.default_rng(seed)
    jc, pc = _chords(rng, 8)
    beats = (0.5 * np.arange(30)).astype(np.float32)
    if accompaniment:
        from audiotabs_tpu.runtime.modes import run_accompaniment_mode

        res = run_accompaniment_mode(_strums(SR, 12.0, 0.3, seed), SR, jc, beats, 120.0, time_signature="4/4")
        return res.score_override, res.pickup_quarters, res.tab_positions, jc, pc, beats
    from audiotabs_tpu.theory.quantize import quantize_note_events_to_score

    jev, _ = _events(rng, 40)
    q = quantize_note_events_to_score(jev, tempo_bpm=120.0, beat_times=beats, time_signature="4/4")
    return q.score, q.pickup_quarters, q.tab_positions, jc, pc, beats


@pytest.mark.parametrize("seed,accompaniment", [(0, False), (1, False), (2, True)])
def test_musicxml_and_midi_bytes_match_jax(tmp_path, seed, accompaniment):
    from audiotabs_tpu.score.musicxml import export_musicxml as jax_xml
    from audiotabs_tpu.tab.fretboard import get_tuning
    from audiotabs_tpu_torch.score.musicxml import export_musicxml

    score, pickup, tabs, jc, pc, beats = _score_case(seed, accompaniment)
    kw = dict(tempo_bpm=120.0, time_signature="4/4", key_signature_fifths=seed - 1, title="job", instrument="guitar",
              beat_times=beats, pickup_quarters=pickup, slash_notation=accompaniment, tab_positions=tabs, tab_tuning=get_tuning("standard"))
    jax_xml(tmp_path / "a.musicxml", score, chords=jc, midi_path=tmp_path / "a.mid", **kw)
    export_musicxml(tmp_path / "b.musicxml", _port(score), chords=pc, midi_path=tmp_path / "b.mid", **kw)
    for ext in ("musicxml", "mid"):
        assert (tmp_path / f"b.{ext}").read_bytes() == (tmp_path / f"a.{ext}").read_bytes(), ext


@pytest.mark.parametrize("seed", [0, 1])
def test_midi_writers_bytes_match_jax(tmp_path, seed):
    from audiotabs_tpu.score import midi as jm
    from audiotabs_tpu_torch.score import midi as pm

    score, _pickup, _tabs, jc, pc, beats = _score_case(seed, False)
    rng = np.random.default_rng(seed)
    jev, pev = _events(rng, 20)
    jm.write_midi_from_score(tmp_path / "a1.mid", score, tempo_bpm=100.0)
    pm.write_midi_from_score(tmp_path / "b1.mid", _port(score), tempo_bpm=100.0)
    jm.write_midi_from_note_events(tmp_path / "a2.mid", jev, tempo_bpm=120.0)
    pm.write_midi_from_note_events(tmp_path / "b2.mid", pev, tempo_bpm=120.0)
    jm.export_chords_midi(tmp_path / "a3.mid", jc, tempo_bpm=120.0, beat_times=list(beats), per_beat=True)
    pm.export_chords_midi(tmp_path / "b3.mid", pc, tempo_bpm=120.0, beat_times=list(beats), per_beat=True)
    for i in (1, 2, 3):
        assert (tmp_path / f"b{i}.mid").read_bytes() == (tmp_path / f"a{i}.mid").read_bytes(), i


@pytest.mark.parametrize("seed,with_key,with_beats", [(0, True, True), (1, False, True), (2, True, False)])
def test_lilypond_pdf_and_csv_bytes_match_jax(tmp_path, seed, with_key, with_beats):
    from audiotabs_tpu.score.csvout import save_note_events_csv as jax_csv
    from audiotabs_tpu.score.lilypond import build_lilypond_score as jax_ly
    from audiotabs_tpu.score.pdfwriter import render_pdf_lead_sheet as jax_pdf
    from audiotabs_tpu_torch.score.csvout import save_note_events_csv
    from audiotabs_tpu_torch.score.lilypond import build_lilypond_score
    from audiotabs_tpu_torch.score.pdfwriter import render_pdf_lead_sheet

    rng = np.random.default_rng(seed)
    jc, pc = _chords(rng, 40)  # long enough for more than one PDF page
    jks = J.KeySignature(tonic="F", mode="major", fifths=-1, name="F major", vexflow="F", use_flats=True, score=0.8) if with_key else None
    pks = _port(jks) if with_key else None
    beats = (0.5 * np.arange(200)).astype(np.float32) if with_beats else None
    kw = dict(tempo_bpm=96.0, beat_times=beats, title="job")
    assert build_lilypond_score(pc, key_signature=pks, **kw) == jax_ly(jc, key_signature=jks, **kw)
    jax_pdf(tmp_path / "a.pdf", jc, key_signature=jks, **kw)
    render_pdf_lead_sheet(tmp_path / "b.pdf", pc, key_signature=pks, **kw)
    assert (tmp_path / "b.pdf").read_bytes() == (tmp_path / "a.pdf").read_bytes()
    jev, pev = _events(rng, 25)
    jax_csv(jev, tmp_path / "a.csv")
    save_note_events_csv(pev, tmp_path / "b.csv")
    assert (tmp_path / "b.csv").read_bytes() == (tmp_path / "a.csv").read_bytes()
