"""Debug mesh construction for the sharded rows.

The reference's TPU production mesh and its roofline constants have no
counterpart here (ROADMAP Queue 1 item 10); a test or a smoke run builds
a small ``("data", "model")`` mesh with :func:`make_debug_mesh`.
"""

from __future__ import annotations

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
