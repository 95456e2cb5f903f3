"""SSSP on the tropical min-plus semiring (paper §V).

On B2SR the adjacency is binary, so edge weights are uniform (=
``edge_weight``, the mxv's ``a_value``): distances are hop counts ×
weight, iterated Bellman-Ford style with the bin·full→full mxv, where
matrix zeros act as +inf.

The reference runs one ``lax.while_loop``; here the loop runs on the host
and syncs once per iteration, on whether any distance dropped.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.core import dispatch
from repro_torch.core.descriptor import Descriptor
from repro_torch.core.graphblas import GraphMatrix
from repro_torch.core.semiring import MIN_PLUS


@dataclasses.dataclass
class SSSPResult:
    distances: torch.Tensor   # float32[n]; +inf = unreachable
    n_iterations: int


@dispatch.scoped
def sssp(g: GraphMatrix, source, edge_weight: float = 1.0,
         max_iters: Optional[int] = None,
         row_chunk: Optional[int] = None) -> SSSPResult:
    """Uniform-weight SSSP from one ``source`` along out-edges.

    An *array* of sources runs through the multi-source engine and
    returns ``MSSSSPResult`` with ``distances[n, S]`` (equal to the looped
    runs for dyadic edge weights).
    """
    if np.ndim(source) > 0:
        if row_chunk is not None:
            raise ValueError("row_chunk is not supported for batched "
                             "sources (the engine plans its own loop)")
        from repro_torch.engine.queries import ms_sssp
        return ms_sssp(g, source, edge_weight=edge_weight,
                       max_iters=max_iters)
    n = g.n_rows
    source = int(source)
    if not 0 <= source < n:
        raise ValueError(f"source {source} out of range for n={n}")
    max_iters = n if max_iters is None else int(max_iters)
    gt = g.transposed()
    desc = Descriptor(row_chunk=row_chunk)

    dist = torch.full((n,), float("inf"), dtype=torch.float32,
                      device=g.device)
    dist[source] = 0.0
    it = 0
    changed = True
    while changed and it < max_iters:
        relax = gt.mxv(dist, MIN_PLUS, desc, a_value=edge_weight)
        new = torch.minimum(dist, relax)
        changed = bool(torch.any(new < dist))
        dist = new
        it += 1
    return SSSPResult(distances=dist, n_iterations=it)
