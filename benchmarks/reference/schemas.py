"""Public data contract, as plain dataclasses.

The fields, defaults and nesting of ``audiotabs_tpu/schemas.py`` (pydantic
models there; the port's machines have no pydantic), so ``result.json`` is
the same artifact: a ScoreData is a list of measures of VexFlow-style items
(keys like "f#/4", duration tokens w/h/q/8/16/32, dots, tuplets, ties).
The job API's bodies are ``JobCreateResponse`` and ``JobInfo``.

Construction coerces as pydantic's lax mode does: numpy scalars become
Python numbers, integers given to a ``float`` field become floats, whole
floats given to an ``int`` field become ints, lists are copied and dicts
given for a nested model are built into it (``_convert`` reads each
field's declared type). ``to_json()`` gives the text of
pydantic's ``model_dump_json()``: compact, fields in declaration order,
``null`` for ``None`` and for non-finite floats. Compare it parsed: the two
may print a float's digits differently.
"""

from __future__ import annotations

import dataclasses
import json
import math
from typing import Literal, Optional

def _int(x) -> int:
    if isinstance(x, bool):
        return int(x)
    f = float(x)
    if f != int(f):
        raise ValueError(f"{x!r} is not a whole number")
    return int(f)


def _convert(t: str, v):
    """``v`` as a value of the field type named ``t`` (pydantic's lax mode)."""
    if t.startswith("Optional["):
        return None if v is None else _convert(t[len("Optional[") : -1], v)
    if t.startswith("list["):
        return [_convert(t[len("list[") : -1], x) for x in v]
    if t == "str" or t.startswith("Literal["):
        return str(v)
    if t in ("float", "int", "bool"):
        return {"float": float, "int": _int, "bool": bool}[t](v)
    return globals()[t](**v) if isinstance(v, dict) else v


def _plain(v):
    if dataclasses.is_dataclass(v):
        return v.to_dict()
    if isinstance(v, list):
        return [_plain(x) for x in v]
    if isinstance(v, float) and not math.isfinite(v):
        return None
    return v


class _Schema:
    def __post_init__(self):
        for f in dataclasses.fields(self):
            setattr(self, f.name, _convert(f.type, getattr(self, f.name)))

    def to_dict(self) -> dict:
        """The fields as plain JSON values, in declaration order (``model_dump(mode="json")``)."""
        return {f.name: _plain(getattr(self, f.name)) for f in dataclasses.fields(self)}

    def to_json(self) -> str:
        """The text of pydantic's ``model_dump_json()`` (compare it parsed)."""
        return json.dumps(self.to_dict(), separators=(",", ":"), allow_nan=False)


JobStatus = Literal["queued", "running", "done", "error"]


@dataclasses.dataclass
class JobCreateResponse(_Schema):
    job_id: str
    status: JobStatus


@dataclasses.dataclass
class JobInfo(_Schema):
    job_id: str
    status: JobStatus
    error: Optional[str] = None


@dataclasses.dataclass
class ChordSegment(_Schema):
    start: float
    end: float
    label: str
    confidence: float


@dataclasses.dataclass
class KeySignature(_Schema):
    tonic: str
    mode: Literal["major", "minor"]
    fifths: int
    name: str
    vexflow: str
    use_flats: bool
    score: float


@dataclasses.dataclass
class TupletSpec(_Schema):
    num_notes: int
    notes_occupied: int


@dataclasses.dataclass(kw_only=True)
class ScoreItem(_Schema):
    rest: bool = False
    keys: list[str] = dataclasses.field(default_factory=list)
    duration: str
    dots: int = 0
    tuplet: Optional[TupletSpec] = None
    tie: Optional[Literal["start", "stop", "continue"]] = None


@dataclasses.dataclass
class ScoreMeasure(_Schema):
    number: int
    items: list[ScoreItem]


@dataclasses.dataclass
class ScoreData(_Schema):
    grid_q: float
    grid_kind: Literal["straight", "triplet"]
    measures: list[ScoreMeasure]


@dataclasses.dataclass
class JobResult(_Schema):
    job_id: str
    tempo_bpm: float
    time_signature: str
    key_signature: Optional[KeySignature] = None
    chords: list[ChordSegment] = dataclasses.field(default_factory=list)
    transcription_backend: Optional[str] = None
    transcription_error: Optional[str] = None
    score: Optional[ScoreData] = None
