"""The fused analysis' outputs of a checkout of the port on the card, and a bitwise comparison of two of them.

    python3 scripts/fused_outputs_diff.py dump OUT.npz [--root DIR]
    python3 scripts/fused_outputs_diff.py compare A.npz B.npz

``dump`` imports ``audiotabs_tpu_torch`` from the checkout DIR (default: the
one holding this script), loads the first four held-out clips of
tests/data/heldout into the 30 s bucket as the batch runner does, and runs
on the card, with separation off (the percussive component as the beat
source) and both chord backends (the template decode and the CRF):
``fused_analysis_batch`` on the four clips as one chunk, then
``fused_analysis`` on each clip alone. Every output goes to OUT.npz, under
"chunk.<key>" and "song<i>.<key>".

``compare`` prints, for each key, whether the two dumps are bit-equal (a NaN
equal to a NaN) or how many elements differ, and exits 1 if a key differs
or is in one dump only. A dump of a parent commit's checkout against one of
this checkout shows whether a change to the fused analysis moved any output
on the card.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
CLIPS = sorted((REPO / "tests" / "data" / "heldout").glob("*.wav"))[:4]


def dump(out: Path, root: Path) -> int:
    sys.path.insert(0, str(root.resolve()))
    import torch

    from audiotabs_tpu_torch.config import Settings
    from audiotabs_tpu_torch.runtime import batch_runner
    from audiotabs_tpu_torch.runtime.fused import fused_analysis, fused_analysis_batch

    if not torch.cuda.is_available():
        print("fused_outputs_diff: no CUDA device is available", file=sys.stderr)
        return 1
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    s = Settings()
    batch, lens, sr = batch_runner._load_and_bucket(CLIPS, s.PAD_SECONDS_BUCKET)
    y = torch.from_numpy(np.ascontiguousarray(batch)).cuda()
    kwargs = dict(switch_penalty=s.SWITCH_PENALTY, separate=True, chord_backend="both")
    res = {}
    with torch.inference_mode():
        chunk = fused_analysis_batch(y, sr, true_lens=lens, **kwargs)
        res |= {f"chunk.{k}": v.cpu().numpy() for k, v in chunk.items()}
        for i in range(len(CLIPS)):
            one = fused_analysis(y[i], sr, true_len=int(lens[i]), **kwargs)
            res |= {f"song{i}.{k}": v.cpu().numpy() for k, v in one.items()}
    np.savez(out, **res)
    print(f"{out}: {len(res)} outputs of {root.resolve()} on {torch.cuda.get_device_name(0)}")
    return 0


def compare(a_path: Path, b_path: Path) -> int:
    a, b = np.load(a_path), np.load(b_path)
    bad = 0
    for k in sorted(set(a.files) | set(b.files)):
        if k not in a.files or k not in b.files:
            print(f"{k}: only in {a_path if k in a.files else b_path}")
            bad += 1
            continue
        x, y = a[k], b[k]
        if x.shape != y.shape or x.dtype != y.dtype:
            print(f"{k}: {x.dtype} {x.shape} against {y.dtype} {y.shape}")
            bad += 1
            continue
        equal = x == y
        if x.dtype.kind == "f":
            equal |= np.isnan(x) & np.isnan(y)
        differ = int(x.size - equal.sum())
        print(f"{k}: {'bit-equal' if not differ else f'{differ} of {x.size} elements differ'}")
        bad += bool(differ)
    print(f"{bad} of {len(set(a.files) | set(b.files))} outputs differ")
    return 1 if bad else 0


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = parser.add_subparsers(dest="cmd", required=True)
    d = sub.add_parser("dump")
    d.add_argument("out", type=Path)
    d.add_argument("--root", type=Path, default=REPO)
    c = sub.add_parser("compare")
    c.add_argument("a", type=Path)
    c.add_argument("b", type=Path)
    args = parser.parse_args()
    return dump(args.out, args.root) if args.cmd == "dump" else compare(args.a, args.b)


if __name__ == "__main__":
    sys.exit(main())
