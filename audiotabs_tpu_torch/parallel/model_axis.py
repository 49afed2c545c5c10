"""Tensor (model-axis) parallelism for a module's weights, as a setting.

Counterpart of audiotabs_tpu/parallel/model_axis.py. There every htdemucs
parameter is ``device_put`` with a NamedSharding that splits its largest
model-divisible axis over the mesh's ``"model"`` axis, and GSPMD inserts
the collectives. Here ``shard_params_model_axis`` splits each such
parameter of a ``torch.nn.Module`` into ``model_size`` shards, one on each
device of the ``"model"`` axis, so each holds ``1/model_size`` of it (the
memory win the JAX docstring names). A parametrization gathers the shards
onto the compute device whenever the layer reads the weight: the
all-gather GSPMD inserts. The compute device is the device of the first
tensor the sharded module is called with (a forward pre-hook records it).
GSPMD may also partition the compute; the port gathers and computes whole
(ROADMAP.md §3). The module's code is unchanged.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.nn.utils import parametrize

from .mesh import Mesh


def model_axis_spec(shape: tuple[int, ...], model_size: int, min_dim: int = 8) -> tuple:
    """The axis to shard, as a ``PartitionSpec`` says it: ``"model"`` at the
    largest axis divisible by ``model_size`` and at least ``min_dim`` long,
    ``None`` elsewhere; ``()`` (replicated) when no axis qualifies."""
    if model_size <= 1:
        return ()
    order = sorted(range(len(shape)), key=lambda a: -shape[a])
    for ax in order:
        if shape[ax] >= min_dim and shape[ax] % model_size == 0:
            return tuple("model" if a == ax else None for a in range(len(shape)))
    return ()


class _ComputeDevice:
    """Where the gathered weights go: set before each forward of the sharded module."""

    def __init__(self, device: torch.device):
        self.device = device


class _GatherShards(nn.Module):
    """Splits a weight along ``axis`` over ``devices`` (``right_inverse``)
    and gathers the shards onto the compute device (``forward``)."""

    def __init__(self, axis: int, devices: list[torch.device], target: _ComputeDevice):
        super().__init__()
        self.axis, self.devices, self.target = axis, devices, target

    def right_inverse(self, full: torch.Tensor) -> tuple[torch.Tensor, ...]:
        parts = full.detach().chunk(len(self.devices), dim=self.axis)
        return tuple(p.to(d, copy=True).contiguous() for p, d in zip(parts, self.devices))

    def forward(self, *shards: torch.Tensor) -> torch.Tensor:
        return torch.cat([s.to(self.target.device) for s in shards], dim=self.axis)


def shard_params_model_axis(module: nn.Module, mesh: Mesh) -> nn.Module:
    """Distribute every parameter of ``module`` that has a model-axis spec
    over the mesh's ``"model"`` devices, in place; the others stay where
    they are. Returns the module. A mesh without a ``"model"`` axis (or of
    size 1 there) leaves it unchanged."""
    model_size = mesh.shape.get("model", 1)
    if model_size <= 1:
        return module
    devices = mesh.axis_devices("model")
    target = _ComputeDevice(devices[0])

    def record(_mod, args, kwargs):
        first = next((a for a in (*args, *kwargs.values()) if isinstance(a, torch.Tensor)), None)
        if first is not None:
            target.device = first.device

    module.register_forward_pre_hook(record, with_kwargs=True)
    for qualified, param in list(module.named_parameters()):
        spec = model_axis_spec(tuple(param.shape), model_size)
        if not spec:
            continue
        owner_name, _, name = qualified.rpartition(".")
        owner = module.get_submodule(owner_name)
        with torch.no_grad():
            parametrize.register_parametrization(owner, name, _GatherShards(spec.index("model"), devices, target))
    return module


def sharded_parameters(module: nn.Module) -> dict[str, list[torch.Tensor]]:
    """{parameter name: its shards} for every distributed parameter of ``module``."""
    out = {}
    for owner_name, owner in module.named_modules():
        if not parametrize.is_parametrized(owner):
            continue
        for name, plist in owner.parametrizations.items():
            if any(isinstance(p, _GatherShards) for p in plist):
                shards = [getattr(plist, f"original{j}") for j in range(len(plist[0].devices))]
                out[f"{owner_name}.{name}" if owner_name else name] = shards
    return out


def sharded_count(module: nn.Module) -> int:
    """How many parameters are distributed over more than one shard."""
    return sum(1 for shards in sharded_parameters(module).values() if len(shards) > 1)
