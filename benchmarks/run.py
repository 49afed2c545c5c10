"""Run one cell of the benchmark once and print its result line.

    python3 benchmarks/run.py --workload mix-clip30 --seed 7 --seconds 51 --trace 0

Set-up (counted in ``setup_s``, from the start of this script): torch and
CUDA, the cell's songs made from the seed and written as WAVs under
``TMPDIR``, the program's kernels from its ``build/`` directory in this
checkout, its checkpoints, and a cold and a warm call of the cell's own
shape. Then a closed loop of calls for ``--seconds`` (``--trace 1``: under
``torch.profiler``, with the benchmark's CUDA events and spans), then the
check against the plain reference. The last line of standard output is the
result's JSON object; the last lines of standard error give each number
compared beside its limit. Exits non-zero, printing no result, without
enough CUDA devices, and when the window loaded JAX or the JAX package."""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE), str(HERE.parent)]  # the benchmark, then the program at the root of the checkout


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    os.environ.setdefault("USE_FLAX", "0")

    from core.cells import load_cell

    cell = load_cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"benchmark: {cell.chips} CUDA device(s) needed, {torch.cuda.device_count() if torch.cuda.is_available() else 0} "
              "available; no result", file=sys.stderr)
        return 3
    from core.runner import forbidden_modules, run_cell

    line, err = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda", T0)
    found = forbidden_modules()
    if found:
        print(f"benchmark: the run loaded {', '.join(found)}; no result", file=sys.stderr)
        return 4
    for text in err:
        print(text, file=sys.stderr)
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
