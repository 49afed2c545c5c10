"""Device selection for the port's entry points.

The port runs on the card. ``None`` and ``"cuda"`` resolve to the current
CUDA device; the CPU is taken only when the caller names it. With no GPU
present and no explicit ``"cpu"``, resolution raises: there is no silent
fallback.
"""

from __future__ import annotations

import numpy as np
import torch

from .tracing import uploaded


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise ValueError(f"audiotabs_tpu_torch runs on cuda, or on cpu when asked; got {dev}")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' to run on the CPU")
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def on_device(y, device: str | torch.device | None = None) -> torch.Tensor:
    """``y`` as a float32 tensor for a device stage: a tensor stays on its
    own device; a host array is uploaded to ``resolve_device(device)``, the
    card unless the caller names the CPU."""
    if isinstance(y, torch.Tensor):
        return y.to(torch.float32)
    return uploaded(torch.from_numpy(np.require(y, np.float32, ["C", "W"])).to(resolve_device(device)), "song")
