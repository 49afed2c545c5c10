"""Device mesh construction.

Counterpart of audiotabs_tpu/parallel/mesh.py. A ``Mesh`` is an n-d array
of ``torch.device`` with axis names, so a 1-D ``"data"`` mesh over every
card and a 2-D ``("data", "model")`` mesh are a setting
(``MESH_SHAPE``/``MESH_AXES``), not a rewrite. One process drives the
whole mesh, as one JAX program does: a ``torch.distributed`` group would
put one process on each card, and NCCL takes no two ranks on one card, so
this is what runs the same code on one card, on several and on the CPU.
A device may appear more than once (the CPU tests pass
``[torch.device("cpu")] * 8``, where the JAX tests use 8 virtual host
devices).

The batch runner splits each chunk's rows over the ``"data"`` axis
(``data_shards``); ``model_axis.py`` splits htdemucs' weights over
``"model"``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import Settings


class Mesh:
    """An n-d array of devices with one name per axis; ``shape`` maps each
    name to its size, as ``jax.sharding.Mesh.shape`` does."""

    def __init__(self, devices: np.ndarray, axis_names: tuple[str, ...]):
        if devices.ndim != len(axis_names):
            raise ValueError(f"{devices.ndim}-d devices with axis names {axis_names}")
        self.devices = devices
        self.axis_names = tuple(axis_names)

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    def axis_devices(self, axis: str) -> list[torch.device]:
        """The devices along ``axis``, at index 0 of every other axis (one
        device when the mesh has no such axis)."""
        if axis not in self.axis_names:
            return [self.devices.flat[0]]
        index = tuple(slice(None) if a == axis else 0 for a in self.axis_names)
        return list(self.devices[index])

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, devices={[str(d) for d in self.devices.flat]})"


def make_mesh(shape: tuple[int, ...] | None = None, axes: tuple[str, ...] = ("data",), devices=None) -> Mesh:
    """A mesh of ``shape`` over the first prod(shape) of ``devices`` (every
    visible card when None; raises when there is none)."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: no CUDA device is available; pass devices=[torch.device('cpu')] * n for the CPU")
        devices = [torch.device(f"cuda:{i}") for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    if shape is None:
        shape = (len(devices),)
    n = int(np.prod(shape))
    if n > len(devices):
        raise ValueError(f"mesh shape {shape} needs {n} devices, have {len(devices)}")
    dev_array = np.empty(n, dtype=object)
    dev_array[:] = devices[:n]
    return Mesh(dev_array.reshape(shape), tuple(axes))


def default_mesh(settings: Settings | None = None) -> Mesh:
    """The mesh that ``MESH_SHAPE``/``MESH_AXES`` describe; every card on
    one ``"data"`` axis when ``MESH_SHAPE`` is empty."""
    s = settings or Settings.from_env()
    if s.MESH_SHAPE:
        shape = tuple(int(x) for x in s.MESH_SHAPE.split(","))
        axes = tuple(a.strip() for a in s.MESH_AXES.split(","))
        return make_mesh(shape, axes)
    return make_mesh()


def data_shards(mesh: Mesh, rows: int) -> list[tuple[torch.device, slice]]:
    """Rows 0..rows-1 split evenly over the ``"data"`` axis, in row order:
    (device, slice of rows) per device. ``rows`` must be a multiple of the
    axis size (the batch runner pads with zero rows)."""
    devices = mesh.axis_devices("data")
    if rows % len(devices):
        raise ValueError(f"{rows} rows do not split over {len(devices)} data devices")
    per = rows // len(devices)
    return [(dev, slice(i * per, (i + 1) * per)) for i, dev in enumerate(devices)]
