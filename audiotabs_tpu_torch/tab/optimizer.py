"""Tab position optimizer: Viterbi/DP over per-event fingering candidates.

Capability parity with the reference's DP optimizer
(reference: backend/app/services/guitar/optimizer.py:175-448), rebuilt with
vectorized numpy transition updates (the K×K move-cost matrix per step is
one broadcast instead of a double Python loop).

Cost model (same shape as the reference):
  candidate cost = 0.08·base_fret + 2·max(0, span-4) + register penalty
                   + string-order penalty − 0.6 open bonus (base ≤ 4)
  transition     = 0.6·|Δbase_fret| + 0.4·|Δavg_string|
                   + 4·max(0, move−5) when the gap is faster than
                     min(0.2 s, 0.35 beat)
Span limit 5 frets (6 above fret 12); ≤6 note candidates, ≤14 chord
candidates from open-shape match or per-pitch backtracking.

The port's copy of ``audiotabs_tpu/tab/optimizer.py``, with the same outputs bit for bit: within one
call each distinct (pitches, label) builds its candidates once, chord candidates are enumerated
depth first in ``product``'s order with a branch cut as soon as it repeats a string or outgrows
every span limit, and the DP reads float64 arrays kept per candidate set, every expression in the
JAX package's order.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Iterable

import numpy as np

from ..tracing import count, traced
from .fretboard import STANDARD_TUNING, pitch_to_fret_options
from .open_chords import matches_open_chord

MAX_FRET_SPAN = 5
MAX_FRET_SPAN_HIGH = 6
MIN_FRET_SPAN = 4
MAX_FRET = 24
CANDIDATES_PER_NOTE = 6
CANDIDATES_PER_CHORD = 14
ONSET_GROUP_WINDOW_S = 0.02


@dataclass(frozen=True)
class HandPosition:
    base_fret: int
    span: int
    finger_assignments: dict[int, int] = field(default_factory=dict)


@dataclass(frozen=True)
class FretPosition:
    string: int
    fret: int
    finger: int | None = None


@dataclass(frozen=True)
class TabEvent:
    time_s: float
    positions: list[FretPosition]
    is_chord: bool
    suggested_hand_position: int | None = None


@dataclass(frozen=True)
class TabOptimizationResult:
    events: list[TabEvent]
    total_cost: float
    position_changes: int
    impossible_transitions: list[tuple[int, int]]


@dataclass(frozen=True)
class _Candidate:
    positions: list[tuple[int, int]]  # (string, fret) aligned with input pitches
    base_fret: int
    span: int
    cost: float
    avg_string: float
    avg_fret: float


def _geometry(positions: list[tuple[int, int]]) -> tuple[int, int]:
    fretted = [f for _, f in positions if f > 0]
    if not fretted:
        return 0, 0
    base = min(fretted)
    return base, max(fretted) - base


def _mean(xs: list[int]) -> float:
    """``np.mean`` of a short list of small ints, bit for bit: their float64 sum is exact, one division rounds it."""
    return float(sum(xs)) / len(xs)


def _candidate_from_positions(positions: list[tuple[int, int]], order: list[int]) -> _Candidate | None:
    """``order``: the indices of the input pitches from lowest to highest (stable)."""
    base, span = _geometry(positions)
    max_span = MAX_FRET_SPAN_HIGH if base >= 12 else MAX_FRET_SPAN
    if span > max_span:
        return None

    cost = 0.08 * base
    if span > MIN_FRET_SPAN:
        cost += 2.0 * (span - MIN_FRET_SPAN)
    if any(f == 0 for _, f in positions) and base <= 4:
        cost -= 0.6

    # (candidates from pitch_to_fret_options always satisfy
    #  fret == pitch - open_pitch, so no register term is needed here; the
    #  base-fret and open-bonus terms above carry the low-position preference)
    # string-order penalty: higher pitches should sit on higher strings
    if len(order) >= 2:
        strings = [positions[i][0] for i in order]
        cost += 0.8 * sum(1 for a, b in zip(strings, strings[1:]) if b > a)

    ss = [s for s, _ in positions]
    fs = [f for _, f in positions]
    return _Candidate(
        positions=positions,
        base_fret=base,
        span=span,
        cost=float(cost),
        avg_string=_mean(ss) if ss else 0.0,
        avg_fret=_mean(fs) if fs else 0.0,
    )


def _note_candidates(pitch: int, tuning) -> list[_Candidate]:
    options = pitch_to_fret_options(pitch, tuning, max_fret=MAX_FRET)
    ranked = sorted(options, key=lambda sf: sf[1] * 0.05 - (0.5 if sf[1] == 0 else 0.0))
    out = []
    for pos in ranked[:CANDIDATES_PER_NOTE]:
        c = _candidate_from_positions([pos], [0])
        if c is not None:
            out.append(c)
    return out


def _chord_combos(per_pitch: list[list[tuple[int, int]]]) -> list[list[tuple[int, int]]]:
    """``product(*per_pitch)`` in its order, less every combination that repeats a string or whose
    fretted span passes ``MAX_FRET_SPAN_HIGH``: a branch is cut at the first such choice, since a
    span only grows as frets are added and no candidate's limit is above that one."""
    out: list[list[tuple[int, int]]] = []
    combo: list[tuple[int, int]] = []

    def walk(depth: int, used: int, lo: int, hi: int) -> None:
        if depth == len(per_pitch):
            out.append(list(combo))
            return
        for s, f in per_pitch[depth]:
            if used >> s & 1:
                continue
            nlo, nhi = (min(lo, f), max(hi, f)) if f > 0 else (lo, hi)
            if nhi - nlo > MAX_FRET_SPAN_HIGH:
                continue
            combo.append((s, f))
            walk(depth + 1, used | 1 << s, nlo, nhi)
            combo.pop()

    walk(0, 0, MAX_FRET, 0)
    return out


def _chord_candidates(pitches: list[int], chord_label: str, tuning) -> list[_Candidate]:
    order = sorted(range(len(pitches)), key=lambda i: pitches[i])
    matched, open_positions = matches_open_chord(pitches, chord_label, tuning=tuning)
    if matched:
        c = _candidate_from_positions(open_positions, order)
        if c is not None:
            return [replace(c, cost=c.cost - 1.0)]  # canonical open shapes win ties

    per_pitch: list[list[tuple[int, int]]] = []
    for p in pitches:
        options = pitch_to_fret_options(p, tuning, max_fret=MAX_FRET)
        if not options:
            return []
        ranked = sorted(options, key=lambda sf: sf[1] * 0.05 - (0.3 if sf[1] == 0 else 0.0))
        per_pitch.append(ranked[:4])

    cands: list[_Candidate] = []
    for combo in _chord_combos(per_pitch):
        c = _candidate_from_positions(combo, order)
        if c is not None:
            cands.append(c)
    cands.sort(key=lambda c: c.cost)
    return cands[:CANDIDATES_PER_CHORD]


def _build_candidates(pitches: list[int], chord_label: str, tuning) -> list[_Candidate]:
    if not pitches:
        return []
    if len(pitches) == 1:
        return _note_candidates(pitches[0], tuning)
    return _chord_candidates(pitches, chord_label, tuning)


class _CandidateSet:
    """One event's candidates (never changed once built, as several events share them) and the
    float64 arrays the DP reads: base fret, mean string, cost, and the mean fretted fret (NaN
    where no string is fretted) that the fast-transition penalty compares."""

    __slots__ = ("cands", "base", "avg_string", "cost", "fret_mean", "index")

    def __init__(self, cands: list[_Candidate]):
        self.cands = cands
        self.base = np.array([c.base_fret for c in cands], dtype=np.float64)
        self.avg_string = np.array([c.avg_string for c in cands], dtype=np.float64)
        self.cost = np.array([c.cost for c in cands], dtype=np.float64)
        fretted = [[f for _, f in c.positions if f > 0] for c in cands]
        self.fret_mean = np.array([_mean(fs) if fs else np.nan for fs in fretted], dtype=np.float64)
        self.index = np.arange(len(cands))


def _transition_penalty_matrix(prev: _CandidateSet, cur: _CandidateSet, fast: bool) -> np.ndarray:
    """[K_prev, K_cur] movement + fast-transition infeasibility penalties."""
    move = 0.6 * np.abs(cur.base[None, :] - prev.base[:, None]) + 0.4 * np.abs(
        cur.avg_string[None, :] - prev.avg_string[:, None]
    )
    if fast:
        fret_move = np.abs(cur.fret_mean[None, :] - prev.fret_mean[:, None])
        penalty = np.where(np.isnan(fret_move), 0.0, np.maximum(0.0, fret_move - 5.0) * 4.0)
        move = move + penalty
    return move


def _fingers(c: _Candidate) -> dict[int, int]:
    out = {}
    for s, f in c.positions:
        if f > 0:
            out[s] = max(1, min(4, f - c.base_fret + 1))
    return out


@traced("quantize/tab")
def optimize_tab_positions_for_events(
    events: Iterable[tuple[float, list[int], str | None]],
    *,
    tuning: tuple[int, ...] = STANDARD_TUNING,
    tempo_bpm: float = 120.0,
) -> TabOptimizationResult:
    normalized = sorted(
        ((float(t), list(p), str(lbl or "")) for t, p, lbl in events), key=lambda e: e[0]
    )
    if not normalized:
        return TabOptimizationResult([], 0.0, 0, [])

    # candidates depend on the pitches in their order and the label alone (the tuning is the call's);
    # the dict lives for this call only
    built: dict[tuple[tuple[int, ...], str], _CandidateSet] = {}
    per_event: list[_CandidateSet] = []
    for _t, pitches, label in normalized:
        key = (tuple(pitches), label)
        cands = built.get(key)
        if cands is None:
            cands = built[key] = _CandidateSet(
                _build_candidates(pitches, label, tuning) or [_Candidate([], 0, 0, 50.0, 0.0, 0.0)]
            )
        per_event.append(cands)
    count("tab_events", len(normalized))
    count("tab_builds", len(built))

    # vectorized Viterbi over candidate indices
    tempo = tempo_bpm if tempo_bpm and tempo_bpm > 0 else 120.0
    fast_below = min(0.2, 0.35 * 60.0 / tempo)
    costs = per_event[0].cost
    steps: list[np.ndarray] = []
    backptrs: list[np.ndarray] = []
    for i in range(1, len(normalized)):
        gap = normalized[i][0] - normalized[i - 1][0]
        trans = _transition_penalty_matrix(per_event[i - 1], per_event[i], gap < fast_below)
        total = costs[:, None] + trans  # [K_prev, K_cur]
        backptrs.append(np.argmin(total, axis=0))
        costs = total[backptrs[-1], per_event[i].index] + per_event[i].cost
        steps.append(trans)

    idx = int(np.argmin(costs))
    path = [idx]
    for bp in reversed(backptrs):
        idx = int(bp[idx])
        path.append(idx)
    path.reverse()

    tab_events: list[TabEvent] = []
    impossible: list[tuple[int, int]] = []
    position_changes = 0
    for i, (t, pitches, _lbl) in enumerate(normalized):
        cand = per_event[i].cands[path[i]]
        fingers = _fingers(cand)
        positions = [FretPosition(s, f, fingers.get(s)) for s, f in cand.positions]
        if i > 0:
            prev = per_event[i - 1].cands[path[i - 1]]
            if cand.base_fret != prev.base_fret:
                position_changes += 1
            pen = steps[i - 1][path[i - 1], path[i]]
            base_move = 0.6 * abs(cand.base_fret - prev.base_fret) + 0.4 * abs(
                cand.avg_string - prev.avg_string
            )
            if pen - base_move > 1e-9:
                impossible.append((i - 1, i))
        tab_events.append(
            TabEvent(
                time_s=t,
                positions=positions,
                is_chord=len(pitches) > 1,
                suggested_hand_position=cand.base_fret if cand.base_fret > 0 else None,
            )
        )

    return TabOptimizationResult(
        events=tab_events,
        total_cost=float(np.min(costs)),
        position_changes=position_changes,
        impossible_transitions=impossible,
    )


def optimize_tab_positions(
    note_events, tuning: tuple[int, ...] = STANDARD_TUNING
) -> list[list[tuple[int, int]]]:
    """Group note events by onset (20 ms window) and optimize positions."""
    evs = sorted(note_events, key=lambda e: float(e.start_time_s))
    grouped: list[tuple[float, list[int]]] = []
    for ev in evs:
        t, p = float(ev.start_time_s), int(ev.pitch_midi)
        if grouped and t - grouped[-1][0] <= ONSET_GROUP_WINDOW_S:
            grouped[-1][1].append(p)
        else:
            grouped.append((t, [p]))
    result = optimize_tab_positions_for_events(
        [(t, ps, None) for t, ps in grouped], tuning=tuning, tempo_bpm=120.0
    )
    return [[(p.string, p.fret) for p in ev.positions] for ev in result.events]
