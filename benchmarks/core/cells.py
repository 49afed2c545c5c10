"""A cell and its files, found by name: ``BENCHMARK.json`` at the root of the
checkout names the workload, its configuration and its traffic mix; the
configuration is the file that its entry names, the mix is
``benchmarks/traffic/<traffic>.json``, each per-layer metric is read by
``benchmarks/metrics/<name>.py`` and a separation net's model FLOPs are
counted by ``benchmarks/nets/<net>.py``. Adding a configuration, a mix, a
metric or a separation net adds files and entries and edits none. A
configuration whose nets are not the checked-in checkpoints names them
under ``weights`` (a seed and the widths, made in set-up), and one whose
plain reference differs from the shared ``benchmarks/reference/`` names
files of its own under ``reference_modules``, each standing in for one
module of it; both are set up by ``core/configured.py``, so such a
configuration too adds only files and entries."""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from typing import Callable

ROOT = Path(__file__).resolve().parents[2]


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list[dict]  # the BENCHMARK.json entries this cell reports
    per_layer: list[dict]
    root: Path


def reports(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def load_cell(workload: str, root: Path = ROOT) -> Cell:
    bench = json.loads((root / "BENCHMARK.json").read_text())
    entry = next((w for w in bench["workloads"] if w["name"] == workload), None)
    if entry is None:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    return Cell(
        name=workload,
        chips=int(entry["chips"]),
        config=json.loads((root / conf["file"]).read_text()),
        traffic=json.loads((root / "benchmarks" / "traffic" / f"{entry['traffic']}.json").read_text()),
        end_to_end=[m for m in bench["end_to_end"] if reports(m, workload)],
        per_layer=[m for m in bench["per_layer"] if reports(m, workload)],
        root=root,
    )


def _load(folder: str, name: str, root: Path):
    """``benchmarks/<folder>/<name>.py`` of the checkout at ``root``, loaded as a module of its own."""
    path = root / "benchmarks" / folder / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"bench_{folder}_{name.replace('.', '_').replace('-', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def reader(metric: str, root: Path = ROOT) -> Callable:
    """The ``read`` function of ``benchmarks/metrics/<metric>.py``."""
    return _load("metrics", metric, root).read


def net_count(net: str, root: Path = ROOT) -> Callable:
    """The ``song(widths, n)`` of ``benchmarks/nets/<net>.py``: the net's model
    FLOPs of a song of ``n`` samples at the analysis rate, from its widths
    (the configuration's ``nets.<net>``)."""
    return _load("nets", net, root).song
