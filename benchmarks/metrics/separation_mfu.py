"""Separation's share of the card's float32 peak: the htdemucs FLOPs of the
window's songs (``core/flops.py::htdemucs_song`` at the configuration's
``nets.htdemucs``, its ``cross_layers`` included, over each song's true
length) over separation's device seconds (the CUDA events that
``separation_ms`` reads) and 67 TFLOP/s, %. The FLOPs are read from the
shapes, the same work whatever implements it. The widths are those of the
configurations of the cells that this metric's ``BENCHMARK.json`` entry
lists; None where they disagree, or where no separation was timed."""

import json
from pathlib import Path

from core.cells import load_cell
from core.flops import htdemucs_song, samples
from core.work import F32_PEAK_FLOPS

ROOT = Path(__file__).resolve().parents[2]


def widths(root: Path = ROOT) -> dict | None:
    """The ``nets.htdemucs`` shared by the cells this metric lists, or None."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    entry = next(m for m in bench["per_layer"] if m["name"] == "separation_mfu")
    found = [load_cell(w, root).config.get("nets", {}).get("htdemucs") for w in entry.get("workloads", [])]
    return found[0] if found and found[0] is not None and all(h == found[0] for h in found) else None


def read(run):
    ms, songs = run.layer_ms.get("separation", (0.0, 0))
    h = widths()
    if not songs or ms <= 0 or h is None:
        return None
    work = sum(htdemucs_song(h, samples(d.song.seconds)) for d in run.done)
    return 100.0 * work / (ms / 1e3) / F32_PEAK_FLOPS
