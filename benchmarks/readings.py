"""The readings that the check's limits are set from, on the card, in one
process:

    python3 benchmarks/readings.py --workload mix-clip30 --seconds 10 \
        --seeds 11 12 13 --control-seeds 21 22 23

For each of ``--seeds``, a run of the cell as ``run.py`` makes it, with a
window of ``--seconds`` (long enough to complete each song the check
samples), and its compared numbers: the lower readings. For each of
``--control-seeds``, the lower-precision control on the songs the check
samples: the reference computed in TF32 (matmul and cuDNN, the precision
below the configuration's float32) in the program's place, compared with
the reference in float32; with separation on, also the reference with
htdemucs under bfloat16 autocast (the program's ``DEMUCS_BF16`` path). One
JSON line a reading, then the largest program reading and the smallest
control reading of each number."""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE), str(HERE.parent)]


def control(cell, seed: int, dev, overrides: dict, tf32: bool) -> dict:
    from core import check, songs
    from core.configured import configured
    from core.runner import sample

    with tempfile.TemporaryDirectory(prefix="audiotabs-control-") as d, configured(cell.config, cell.root, Path(d), dev):
        tmp = Path(d)
        (tmp / "songs").mkdir()
        song_list = songs.make_songs(cell.traffic, seed, tmp / "songs", dev)
        rows = sorted(sample(cell, seed))
        ref = check.Reference(cell.config.get("settings", {}), dev, tmp=tmp)
        low = check.Reference(cell.config.get("settings", {}) | overrides, dev, tf32=tf32, tmp=tmp)
        readings = []
        if cell.traffic["loop"] == "single":
            for i in rows:
                r, _ = ref.single(song_list[i].path, f"song{i:02d}", None)
                c, _ = low.single(song_list[i].path, f"song{i:02d}", None)
                readings.append(check.compare(c, r, None))
        else:
            paths = [s.path for s in song_list]
            r, c = ref.batch(paths, rows, {}), low.batch(paths, rows, {})
            readings = [check.compare(c[i][0], r[i][0], None) for i in rows]
    return check.worst(readings)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    args = ap.parse_args()
    import torch

    from core.cells import load_cell
    from core.runner import run_cell

    cell = load_cell(args.workload)
    dev = torch.device("cuda")
    lower, upper = {}, {}
    for seed in args.seeds:
        line, err = run_cell(cell, seed, args.seconds, False, "cuda", time.perf_counter())
        nums = {k: v["value"] for k, v in line["compared"].items()}
        print(json.dumps({"reading": "program", "seed": seed, "correct": line["correct"], "numbers": nums,
                          "metrics": {k: v["value"] for k, v in line["metrics"].items()}}), flush=True)
        for k, v in nums.items():
            lower[k] = max(lower.get(k, v), v) if v is not None else lower.get(k)
    controls = [("tf32", {}, True)]
    if cell.config.get("settings", {}).get("ENABLE_DEMUCS", True):
        controls.append(("demucs_bf16", {"DEMUCS_BF16": True}, False))
    for seed in args.control_seeds:
        for name, overrides, tf32 in controls:
            nums = control(cell, seed, dev, overrides, tf32)
            print(json.dumps({"reading": name, "seed": seed, "numbers": nums}), flush=True)
            for k, v in nums.items():
                upper.setdefault(name, {})[k] = min(upper.get(name, {}).get(k, v), v)
    print(json.dumps({"lower": lower, "upper": upper, "seconds": time.perf_counter() - T0}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
