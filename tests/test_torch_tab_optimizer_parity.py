"""The port's tab optimizer (``audiotabs_tpu_torch/tab/optimizer.py``) against the JAX package's.

The port builds each distinct (pitches, label) of a call once, enumerates chord candidates depth
first with pruning, and runs the DP over arrays kept per candidate set; the JAX package rebuilds
every event's candidates from ``product`` and the DP's arrays from lists. The outputs must be the
same bit for bit: every ``TabEvent``, ``total_cost``, ``position_changes`` and
``impossible_transitions``, compared with ``==`` and by type. Event lists are drawn from fixed
seeds: single notes, chords of 2 to 7 pitches (7 fit no six strings: the 50.0 placeholder), pitch
sets repeated and in another order, empty lists, pitches off the fretboard, labels that name an
open shape and labels that do not, fast and slow gaps, every tuning, tempi of 0, below 0 and above.
The counters ``tab_events`` and ``tab_builds`` count each call's events and builds, and calls in
two threads at once give the serial outputs.
"""

from __future__ import annotations

import dataclasses
import sys
from concurrent.futures import ThreadPoolExecutor
from itertools import product
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
from torch.profiler import ProfilerActivity, profile

from audiotabs_tpu.tab import optimizer as J
from audiotabs_tpu_torch import tracing
from audiotabs_tpu_torch.tab import optimizer as P
from audiotabs_tpu_torch.tab.fretboard import TUNINGS, pitch_to_fret_options, positions_to_pitches
from audiotabs_tpu_torch.tab.open_chords import OPEN_POSITION_CHORDS, shape_to_positions

LABELS = ["", "N", "C:maj", "G:maj", "A:min", "E:7", "D:min7", "F:maj", "B:dim", "C#:maj7"]
GAPS = [0.0, 0.01, 0.05, 0.1, 0.15, 0.19, 0.25, 0.5, 1.0]  # fast below min(0.2 s, 0.35 beat)
TEMPI = [120.0, 0.0, -40.0, 70.0, 200.0]
INTERVALS = [0, 3, 4, 7, 10, 12, 14, 16, 19, 24]


def _chord(rng: np.random.Generator, tuning: tuple[int, ...], size: int, replace: bool = False) -> list[int]:
    root = int(rng.integers(tuning[0], tuning[-1] + 8))
    return [root + int(i) for i in rng.choice(INTERVALS, size=size, replace=replace)]


def _canon(x):
    """Field dicts of dataclasses, every leaf with its type's name."""
    if dataclasses.is_dataclass(x):
        return {f.name: _canon(getattr(x, f.name)) for f in dataclasses.fields(x)}
    if isinstance(x, (list, tuple)):
        return [type(x).__name__, [_canon(v) for v in x]]
    if isinstance(x, dict):
        return {k: _canon(v) for k, v in x.items()}
    return (type(x).__name__, x)


def _pitch_sets(rng: np.random.Generator, tuning: tuple[int, ...]) -> list[tuple[list[int], str]]:
    """A song's vocabulary: open shapes sounded in the tuning, drawn chords and notes, an empty list,
    a pitch off the fretboard, and two sets in another order."""
    sets = []
    for name in rng.choice(sorted(OPEN_POSITION_CHORDS), size=3, replace=False):
        pitches = positions_to_pitches(shape_to_positions(OPEN_POSITION_CHORDS[name]), tuning)
        sets.append(([int(p) for p in rng.permutation(pitches)[: rng.integers(2, len(pitches) + 1)]], str(name)))
    for size in (1, 1, 2, 3, 4, 5, 6, 7, int(rng.integers(2, 7))):
        sets.append((_chord(rng, tuning, size), str(rng.choice(LABELS))))
    sets += [([], ""), ([tuning[0] - 3], ""), ([tuning[0] - 3, tuning[0] + 2], "")]
    for pitches, label in sets[3:5]:
        sets.append((pitches[::-1], label))
    return sets


def _events(seed: int, tuning: tuple[int, ...]) -> list[tuple[float, list[int], str | None]]:
    """About 40 events over the seed's vocabulary, in an order the optimizer has to sort; labels
    of None, as the quantizer passes them, on a third of them."""
    rng = np.random.default_rng(seed)
    sets = _pitch_sets(rng, tuning)
    t, out = 0.0, []
    for _ in range(int(rng.integers(30, 50))):
        t += float(rng.choice(GAPS))
        pitches, label = sets[int(rng.integers(len(sets)))]
        out.append((t, list(pitches), None if rng.random() < 1 / 3 else label))
    return [out[i] for i in rng.permutation(len(out))]


@pytest.mark.parametrize("tuning", sorted(TUNINGS))
@pytest.mark.parametrize("seed", range(4))
def test_events_equal_the_jax_package(seed, tuning):
    events, tuning = _events(seed, TUNINGS[tuning]), TUNINGS[tuning]
    tempo = TEMPI[seed % len(TEMPI)]
    got = P.optimize_tab_positions_for_events(events, tuning=tuning, tempo_bpm=tempo)
    want = J.optimize_tab_positions_for_events(events, tuning=tuning, tempo_bpm=tempo)
    assert _canon(got) == _canon(want)
    assert len(got.events) == len(events)


def test_the_draws_reach_every_branch():
    """Placeholders, open shapes, equal-cost candidates, fast penalties and repeated sets occur."""
    costs, open_shape, repeated = [], 0, 0
    for seed in range(4):
        events = _events(seed, TUNINGS["standard"])
        keys = [(tuple(p), str(lbl or "")) for _, p, lbl in events]
        repeated += len(keys) - len(set(keys))
        for pitches, label in set(keys):
            cands = P._build_candidates(list(pitches), label, TUNINGS["standard"])
            costs.append([c.cost for c in cands])
            open_shape += len(cands) == 1 and len(pitches) > 1
        result = P.optimize_tab_positions_for_events(events, tempo_bpm=120.0)
        assert any(not e.positions for e in result.events)  # the placeholder
    assert open_shape and repeated
    assert any(len(set(c)) < len(c) for c in costs)  # ties that the stable sort and argmin must keep
    assert sum(len(P.optimize_tab_positions_for_events(_events(s, TUNINGS["standard"])).impossible_transitions)
               for s in range(4))


@pytest.mark.parametrize("events, tied", [
    ([(0.0, [48, 52], ""), (0.5, [60], ""), (1.0, [63], "")], "steps"),  # two columns with equal minima
    ([(0.0, [70, 50], ""), (0.1, [62], ""), (0.2, [45], "")], "end"),  # fast gaps, two paths end equal
])
def test_ties_take_the_first_path(events, tied):
    sets = [P._CandidateSet(P._build_candidates(p, lbl, TUNINGS["standard"])) for _, p, lbl in events]
    costs, step_ties = sets[0].cost, 0
    for (t0, *_), (t1, *_), a, b in zip(events, events[1:], sets, sets[1:]):
        total = costs[:, None] + P._transition_penalty_matrix(a, b, t1 - t0 < 0.175)
        step_ties += int(((total == total.min(axis=0)).sum(axis=0) > 1).sum())
        costs = total.min(axis=0) + b.cost
    assert (step_ties > 0) if tied == "steps" else (costs == costs.min()).sum() > 1
    got, want = P.optimize_tab_positions_for_events(events), J.optimize_tab_positions_for_events(events)
    assert _canon(got) == _canon(want)


@pytest.mark.parametrize("seed", range(5))
def test_note_groups_equal_the_jax_package(seed):
    rng = np.random.default_rng(100 + seed)
    notes, t = [], 0.0
    for _ in range(60):
        t += float(rng.choice([0.0, 0.005, 0.015, 0.03, 0.1, 0.4]))
        notes.append(SimpleNamespace(start_time_s=t, pitch_midi=int(rng.integers(38, 90))))
    notes = [notes[i] for i in rng.permutation(len(notes))]
    tuning = TUNINGS[sorted(TUNINGS)[seed]]
    assert _canon(P.optimize_tab_positions(notes, tuning)) == _canon(J.optimize_tab_positions(notes, tuning))


@pytest.mark.parametrize("tuning", sorted(TUNINGS))
def test_pruned_enumeration_is_products_list(tuning):
    """Before the cut to 14, the candidates are ``product``'s, in its order, ties included."""
    tuning = TUNINGS[tuning]
    rng = np.random.default_rng(len(tuning) + tuning[0])
    checked = 0
    for _ in range(60):
        pitches = _chord(rng, tuning, int(rng.integers(2, 7)), replace=bool(rng.random() < 0.2))
        per_pitch = [sorted(pitch_to_fret_options(p, tuning, max_fret=P.MAX_FRET),
                            key=lambda sf: sf[1] * 0.05 - (0.3 if sf[1] == 0 else 0.0))[:4] for p in pitches]
        order = sorted(range(len(pitches)), key=lambda i: pitches[i])
        want = [J._candidate_from_positions(pitches, list(c), tuning) for c in product(*per_pitch)
                if len({s for s, _ in c}) == len(c)]
        got = [P._candidate_from_positions(c, order) for c in P._chord_combos(per_pitch)]
        want, got = [c for c in want if c is not None], [c for c in got if c is not None]
        assert _canon(got) == _canon(want)
        checked += len(want)
    assert checked > 100


@pytest.mark.parametrize("seed", range(3))
def test_sum_over_count_is_np_mean(seed):
    rng = np.random.default_rng(seed)
    for _ in range(3000):
        xs = [int(v) for v in rng.integers(0, 25, size=int(rng.integers(1, 10)))]
        got, want = P._mean(xs), float(np.mean(xs))
        assert np.float64(got).tobytes() == np.float64(want).tobytes(), xs


def test_counters_count_events_and_builds_per_call():
    events = _events(7, TUNINGS["standard"])
    keys = {(tuple(p), str(lbl or "")) for _, p, lbl in events}
    for _ in range(2):  # a second call on the same events builds again: no cache outlives a call
        before = tracing.counters()
        P.optimize_tab_positions_for_events(events)
        after = tracing.counters()
        assert after["tab_events"] - before.get("tab_events", 0) == len(events)
        assert after["tab_builds"] - before.get("tab_builds", 0) == len(keys) < len(events)


def test_the_benchmark_reads_the_kept_builds(monkeypatch):
    """Under a profiler the counters are kept, and ``benchmarks/metrics/tab_builds.py`` reads them a song."""
    bench = Path(__file__).resolve().parents[1] / "benchmarks"
    monkeypatch.syspath_prepend(str(bench))
    from core import cells, program

    events = _events(8, TUNINGS["standard"])
    builds = len({(tuple(p), str(lbl or "")) for _, p, lbl in events})
    before = tracing.recorded()[1]
    with profile(activities=[ProfilerActivity.CPU]):
        P.optimize_tab_positions_for_events(events)
        P.optimize_tab_positions_for_events(events)
    after = tracing.recorded()[1]
    kept = {k: after[k] - before.get(k, 0) for k in ("tab_events", "tab_builds")}
    assert kept == {"tab_events": 2 * len(events), "tab_builds": 2 * builds}
    monkeypatch.setattr(program, "recorded", lambda: ([], kept))
    run = SimpleNamespace(done=[None, None])
    assert cells.reader("tab_builds")(run) == builds
    monkeypatch.setattr(program, "recorded", lambda: ([], {"const_uploads": 3}))  # a program without it
    assert cells.reader("tab_builds")(run) is None


def test_threads_give_the_serial_outputs():
    jobs = [(_events(seed, TUNINGS[name]), TUNINGS[name]) for seed, name in enumerate(sorted(TUNINGS) * 2)]
    serial = [_canon(P.optimize_tab_positions_for_events(e, tuning=t)) for e, t in jobs]
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with ThreadPoolExecutor(max_workers=4) as pool:
            futures = [pool.submit(P.optimize_tab_positions_for_events, e, tuning=t) for e, t in jobs * 3]
            got = [_canon(f.result(timeout=120)) for f in futures]
    finally:
        sys.setswitchinterval(switch)
    assert got == serial * 3
