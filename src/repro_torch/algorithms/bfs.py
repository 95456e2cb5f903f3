"""BFS on the boolean semiring with bit-packed frontiers (paper §V).

Each iteration is one masked bin·bin→bin mxv over the stored transpose:
push iterations resolve the ``mxv`` row, pull iterations the early-exit
``mxv_pull`` row, as ``repro_torch.algorithms.direction`` decides. The
frontier and visited set stay packed int32 words on the device; levels
are stamped into an int32 vector.

The reference runs one ``lax.while_loop``; here the loop runs on the host
and syncs once per iteration, reading the frontier and visited popcounts
together (the frontier count doubles as the termination test).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.algorithms import direction as direction_mod
from repro_torch.algorithms.direction import DirectionConfig
from repro_torch.core import dispatch
from repro_torch.core.descriptor import Descriptor
from repro_torch.core.graphblas import GraphMatrix
from repro_torch.core.operands import BitVector


@dataclasses.dataclass
class BFSResult:
    """Result of a single-source traversal.

    ``levels`` is ``int32[n]`` with ``levels[source] == 0`` and -1 for
    unreachable vertices; ``max_iters=0`` stamps only the source.
    ``directions`` records the direction used by each iteration run.
    """

    levels: torch.Tensor   # int32[n]; -1 = unreachable
    n_iterations: int
    directions: Tuple[str, ...] = ()


def _check_max_iters(max_iters: Optional[int], n: int) -> int:
    if max_iters is None:
        return n
    max_iters = int(max_iters)
    if max_iters < 0:
        raise ValueError(f"max_iters must be >= 0, got {max_iters}")
    return max_iters


@dispatch.scoped
def bfs(g: GraphMatrix, source, max_iters: Optional[int] = None,
        row_chunk: Optional[int] = None,
        direction: Union[str, DirectionConfig, None] = "auto") -> BFSResult:
    """Hop levels from ``source`` following out-edges.

    ``direction`` is ``"auto"`` (push/pull switching), ``"push"``,
    ``"pull"`` or a :class:`DirectionConfig`. All modes are bit-exact;
    the schedule run is recorded on ``BFSResult.directions``.

    An *array* of sources runs through the multi-source engine (one wide
    frontier-matrix traversal) and returns its ``MSBFSResult`` with
    ``levels[n, S]``, column ``s`` equal to the run from ``source[s]``.
    """
    cfg = direction_mod.as_config(direction)
    n = g.n_rows
    max_iters = _check_max_iters(max_iters, n)
    if np.ndim(source) > 0:
        if row_chunk is not None:
            raise ValueError("row_chunk is not supported for batched "
                             "sources (the engine plans its own loop)")
        from repro_torch.engine.queries import msbfs
        return msbfs(g, source, max_iters=max_iters, direction=cfg)
    source = int(source)
    if not 0 <= source < n:
        raise ValueError(f"source {source} out of range for n={n}")
    # both directions traverse Aᵀ · frontier over the stored transpose
    gt = g.transposed()
    avg_degree = g.nnz / max(n, 1)
    dev = g.device

    src = torch.zeros(n, dtype=torch.int32, device=dev)
    src[source] = 1
    frontier = BitVector.pack(src, g.tile_dim, n)
    visited = frontier
    levels = torch.full((n,), -1, dtype=torch.int32, device=dev)
    levels[source] = 0

    d = direction_mod.initial_direction(cfg)
    locked = False
    trace = []
    it = 0
    live = True
    while live and it < max_iters:
        nxt = gt.mxv(frontier, desc=Descriptor(
            mask=visited, complement=True, row_chunk=row_chunk,
            direction="pull" if d == direction_mod.PULL else None))
        visited = visited | nxt
        levels = torch.where(nxt.unpack(torch.bool) & (levels < 0),
                             it + 1, levels)
        trace.append(d)
        nnz_f, nnz_v = torch.stack([direction_mod.nnz_words(nxt.words),
                                    direction_mod.nnz_words(visited.words)
                                    ]).tolist()
        d, locked = direction_mod.next_direction(cfg, d, locked, nnz_f, nnz_v,
                                                 n, avg_degree)
        frontier = nxt
        it += 1
        live = nnz_f > 0
    dirs = direction_mod.trace_tuple(trace, it)
    direction_mod.observe_trace(dirs, kernel="bfs")
    return BFSResult(levels=levels, n_iterations=it, directions=dirs)
