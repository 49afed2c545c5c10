"""The optimizers and schedules of the JAX trainers, in torch.

``optax.adam`` / ``optax.adamw`` become ``torch.optim.Adam`` / ``AdamW``
(b1 0.9, b2 0.999, eps 1e-8 outside the square root, bias-corrected, AdamW's
decay scaled by the scheduled rate and applied to the old weights, as optax
chains it), and ``optax.cosine_decay_schedule`` a ``LambdaLR``. optax applies
``schedule(0)`` to the first update, so ``Trainer.step`` steps the scheduler
after the optimizer.
"""

from __future__ import annotations

import math
from contextlib import contextmanager

import torch


def cosine_decay(decay_steps: int, alpha: float):
    """optax.cosine_decay_schedule's factor on the initial value at update ``count``."""
    if decay_steps <= 0:
        raise ValueError("decay_steps must be positive")

    def factor(count: int) -> float:
        c = min(count, decay_steps)
        return (1 - alpha) * 0.5 * (1 + math.cos(math.pi * c / decay_steps)) + alpha

    return factor


class Trainer:
    """Adam or AdamW (``weight_decay``) under a cosine-decayed rate over ``params``."""

    def __init__(self, params, lr: float, steps: int, alpha: float, weight_decay: float | None = None):
        params = list(params)
        if weight_decay is None:
            self.opt = torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8)
        else:
            self.opt = torch.optim.AdamW(params, lr=lr, betas=(0.9, 0.999), eps=1e-8, weight_decay=weight_decay)
        self.sched = torch.optim.lr_scheduler.LambdaLR(self.opt, cosine_decay(steps, alpha))

    def step(self) -> None:
        """Apply the gradients in ``.grad`` at this update's rate, then clear them."""
        self.opt.step()
        self.sched.step()
        self.opt.zero_grad(set_to_none=True)


def norm_as_parameters(net: torch.nn.Module) -> None:
    """Make ``feat_mean``/``feat_std`` parameters of ``net``: the JAX trainers
    keep them in the optimizer with zeroed gradients, so AdamW's weight decay
    shrinks them as it does every other leaf."""
    for name in ("feat_mean", "feat_std"):
        if getattr(net, name, None) is not None:
            setattr(net, name, torch.nn.Parameter(getattr(net, name).detach().clone()))


def zero_norm_grads(net: torch.nn.Module) -> None:
    """The JAX trainers' ``grads["feat_mean"] = 0`` (the normalisation is data, not trainable)."""
    for name in ("feat_mean", "feat_std"):
        p = getattr(net, name, None)
        if isinstance(p, torch.nn.Parameter):
            p.grad = torch.zeros_like(p)


@contextmanager
def no_tf32():
    """Full float32 matmuls and convolutions (TF32 off), as the JAX reference computes."""
    old = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def device_arg(ap) -> None:
    ap.add_argument("--device", default="cuda", help="cuda (default), or cpu only when asked")


class StepTimer:
    """Per-step time: CUDA events on the card (read once, at the end, so no
    step waits for the device), the host clock on the CPU."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.marks: list = []

    def mark(self) -> None:
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.marks.append(ev)
        else:
            import time

            self.marks.append(time.perf_counter())

    def ms(self) -> list[float]:
        """Milliseconds between consecutive marks."""
        if self.cuda:
            torch.cuda.synchronize()
            return [a.elapsed_time(b) for a, b in zip(self.marks, self.marks[1:])]
        return [1e3 * (b - a) for a, b in zip(self.marks, self.marks[1:])]
