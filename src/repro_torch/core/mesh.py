"""Device meshes for the sharded rows: the port's ``jax.sharding.Mesh``.

A :class:`ShardMesh` is an object array of ``torch.device`` slots with
named axes. A sharded ``GraphMatrix`` (``GraphMatrix.shard``) gives shard
``p`` the ``p``-th slot in row-major order; one process launches every
shard's kernel on its slot's device and moves the combines' words between
slots with ``Tensor.to`` (single-controller execution: a call on a
sharded graph returns the global result, as the reference's does).

Slots may repeat a device. Four slots on one card run the ragged
partition, the exchange plan's index arrays and every per-shard launch on
that card, the counterpart of the reference tests' forced host devices;
the CPU tests build meshes of CPU slots in-process the same way.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device


class ShardMesh:
    """Named axes over an object ndarray of ``torch.device`` slots."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str]):
        devices = np.asarray(devices, dtype=object)
        axis_names = tuple(axis_names)
        if devices.ndim != len(axis_names):
            raise ValueError(f"{devices.ndim}-d device array for axes "
                             f"{axis_names}")
        if len(set(axis_names)) != len(axis_names):
            raise ValueError(f"repeated axis name in {axis_names}")
        if devices.size == 0:
            raise ValueError("a mesh needs at least one slot")
        self.devices = devices
        self.axis_names = axis_names

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    def __repr__(self) -> str:
        return (f"ShardMesh({dict(self.shape)}, "
                f"{[str(d) for d in self.devices.flat]})")


def make_mesh(shape: Sequence[int], axes: Sequence[str],
              devices: Optional[Sequence[DeviceLike]] = None) -> ShardMesh:
    """A mesh of ``shape`` (one ``-1`` entry takes the rest) named ``axes``.

    ``devices`` lists the slots' devices in row-major order, repeats
    allowed; the default is every visible CUDA device (none raises: the
    CPU is used only when the caller lists it).
    """
    if devices is None:
        resolve_device("cuda")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devs = [resolve_device(d) for d in devices]
    shape = list(shape)
    if shape.count(-1) > 1:
        raise ValueError(f"at most one -1 in the mesh shape {tuple(shape)}")
    if -1 in shape:
        rest = int(np.prod([s for s in shape if s != -1]))
        if rest < 1 or len(devs) % rest:
            raise ValueError(f"{len(devs)} device(s) do not fill a mesh of "
                             f"shape {tuple(shape)}")
        shape[shape.index(-1)] = len(devs) // rest
    n = int(np.prod(shape))
    if n != len(devs):
        raise ValueError(f"a mesh of shape {tuple(shape)} needs {n} "
                         f"slot(s), got {len(devs)}")
    arr = np.empty(n, dtype=object)
    arr[:] = devs
    return ShardMesh(arr.reshape(shape), axes)
