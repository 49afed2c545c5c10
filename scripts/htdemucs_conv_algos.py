"""Time every convolution of the port's htdemucs on the card, three ways.

    python3 scripts/htdemucs_conv_algos.py

Runs the checked-in checkpoint's net once on a 14-window batch (the 30 s
bucket's windows), keeps each convolution module's input, and times the
module alone (CUDA events, median of 5) with cuDNN's default algorithm
choice, with ``cudnn.benchmark``, and with cuDNN off (PyTorch's own
im2col + GEMM), beside the workspace it peaks at. The decoder's 3×3
rewrites are also timed as the port runs them (``_conv3x3``: im2col and
one matrix product). TF32 is off, as in the port's f32 path. Prints the
slowest convolutions and the card's name and power limit.
"""

from __future__ import annotations

import statistics
import subprocess
import sys
from pathlib import Path

import torch
import torch.nn as nn

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from audiotabs_tpu_torch.models import htdemucs  # noqa: E402

CONVS = (nn.Conv1d, nn.Conv2d, nn.ConvTranspose1d, nn.ConvTranspose2d)


def cuda_ms(fn, reps: int = 5) -> float:
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device is available", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"], capture_output=True, text=True, check=True)
    print(smi.stdout.strip().splitlines()[0])
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    net = htdemucs.load_model(dev)
    inputs = []
    hooks = [m.register_forward_hook(lambda mod, inp, out, name=name: inputs.append((name, mod, inp[0].clone())))
             for name, m in net.named_modules() if isinstance(m, CONVS)]
    # the decoder's 3×3 rewrites do not call their module (the port runs them
    # through _conv3x3), so their input, x + skip, is taken at the layer
    hooks += [m.register_forward_hook(lambda mod, inp, out, name=name: inputs.append((f"{name}.rewrite", mod.rewrite, inp[0] + inp[1])))
              for name, m in net.named_modules() if isinstance(m, htdemucs.DecFreq)]
    with torch.inference_mode():
        net(0.1 * torch.randn(14, 2, 131072, device=dev))
    for h in hooks:
        h.remove()

    rows = []
    with torch.inference_mode():
        for name, mod, x in inputs:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            default = cuda_ms(lambda: mod(x))
            workspace_mb = (torch.cuda.max_memory_allocated() - base) / 2**20
            with torch.backends.cudnn.flags(enabled=True, benchmark=True, allow_tf32=False):
                bench = cuda_ms(lambda: mod(x))
            with torch.backends.cudnn.flags(enabled=False):
                no_cudnn = cuda_ms(lambda: mod(x), reps=3)
            im2col = cuda_ms(lambda: htdemucs._conv3x3(x, mod)) if name.endswith("rewrite") and name.startswith("decoder") else None
            rows.append((default, name, tuple(x.shape), bench, no_cudnn, im2col, workspace_mb))
    print(f"{len(rows)} convolutions; summed ms: cuDNN default {sum(r[0] for r in rows):.2f}, "
          f"benchmark {sum(r[3] for r in rows):.2f}, cuDNN off {sum(r[4] for r in rows):.2f}")
    for default, name, shape, bench, no_cudnn, im2col, ws in sorted(rows, reverse=True)[:12]:
        extra = "" if im2col is None else f", im2col + matmul {im2col:.3f}"
        print(f"{name} {shape}: cuDNN default {default:.3f} ms (peak {ws:.1f} MiB over the input), "
              f"benchmark {bench:.3f}, cuDNN off {no_cudnn:.3f}{extra}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
