"""Meshes: the debug mesh of the sharded graph rows, and the production
``DeviceMesh`` of the SPMD layer with the process groups under it.

Two designs live side by side. :func:`make_debug_mesh` builds a
``core.mesh.ShardMesh``: one process drives every slot (the sharded
B2SR rows). :func:`make_production_mesh` builds a ``torch.distributed``
``DeviceMesh`` over the default process group, one rank a device, for
the DTensor path of the LM (the counterpart of the reference's
``jax.sharding.Mesh``). :func:`fake_world` opens a process group of
``n`` ranks that only this process plays (``"fake"`` backend: every
collective returns at once), which together with ``FakeTensorMode``
lets the dry run place and step a model at the production mesh with no
device. :func:`real_world` opens the process group of a real run.
The reference's TPU roofline constants have no counterpart here.
"""

from __future__ import annotations

import contextlib
import math
import os
import socket
from typing import Optional, Sequence

import torch

from repro_torch.core.mesh import ShardMesh, make_mesh
from repro_torch.device import DeviceLike, resolve_device


def make_debug_mesh(n_devices: Optional[int] = None, model: int = 2,
                    devices: Optional[Sequence[DeviceLike]] = None
                    ) -> ShardMesh:
    """A ``(n // model, model)`` mesh named ``("data", "model")`` over the
    first ``n`` of ``devices`` (default: every visible CUDA device).

    ``n`` must divide evenly by ``model``: a floor division would build a
    mesh over fewer devices than asked, so it raises instead.
    """
    if devices is None:
        resolve_device("cuda")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    avail = len(devices)
    n = n_devices or avail
    if n < 1 or n > avail:
        raise ValueError(f"make_debug_mesh: n_devices={n} out of range — "
                         f"{avail} device(s) available")
    if n % model != 0:
        raise ValueError(
            f"make_debug_mesh: n_devices={n} is not divisible by "
            f"model={model} — a ({n // model}, {model}) mesh would silently "
            f"drop {n - (n // model) * model} device(s); pick model from the "
            f"divisors of {n} or pass a matching n_devices")
    return make_mesh((n // model, model), ("data", "model"), devices[:n])


def make_production_mesh(multi_pod: bool = False,
                         device_type: str = "cuda"):
    """16 × 16 ranks ``("data", "model")``, or ``(2, 16, 16)`` with a
    leading ``"pod"``, over the default process group: the first ``n``
    ranks (the single-pod mesh in a 512-rank world takes 256)."""
    from torch.distributed.device_mesh import DeviceMesh
    import torch.distributed as dist
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = math.prod(shape)
    world = dist.get_world_size()
    if world < n:
        raise ValueError(f"make_production_mesh: the {shape} mesh needs "
                         f"{n} ranks, the world has {world}")
    return DeviceMesh(device_type, torch.arange(n).reshape(shape),
                      mesh_dim_names=axes)


@contextlib.contextmanager
def fake_world(n: int):
    """A default process group of ``n`` ranks played by this process
    alone (rank 0, the ``"fake"`` backend); destroyed on exit."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=n)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@contextlib.contextmanager
def real_world(device: DeviceLike = None):
    """The default process group of a real run, destroyed on exit: under
    ``torchrun`` (``RANK``, ``WORLD_SIZE`` and ``MASTER_ADDR`` set) from
    the environment, each rank on ``cuda:LOCAL_RANK``; otherwise one rank
    on ``device`` (None = the card): NCCL on the card, gloo on the
    CPU. Yields the rank's device."""
    import torch.distributed as dist
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        dev = resolve_device(device)
        if dev.type == "cuda":
            dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
            torch.cuda.set_device(dev)
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo")
    else:
        dev = resolve_device(device)
        dist.init_process_group(
            "nccl" if dev.type == "cuda" else "gloo",
            init_method=f"tcp://localhost:{_free_port()}", rank=0,
            world_size=1)
    try:
        yield dev
    finally:
        dist.destroy_process_group()
