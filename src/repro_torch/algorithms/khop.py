"""k-hop reachability / neighbourhood expansion by repeated masked mxm.

With A the boolean adjacency (the reference's formulation):

    R_1 = A,    F_1 = A
    F_{i+1} = (F_i ∨.∧ A)⟨¬R_i⟩        -- frontier: newly reached pairs
    R_{i+1} = R_i ∨ F_{i+1}            -- reached within i+1 hops

The complemented structural mask ⟨¬R_i⟩ is the matrix form of BFS's
visited mask, applied before the store, so every frontier product stays
sparse. The loop stops early when a frontier is empty.

Every backend runs the same loop through ``GraphMatrix.mxm``: on
``b2sr_cuda`` each hop is one launch of the SpGEMM kernel with the mask
applied inside it; R ∨ F merges the two sparse tile lists. Nothing goes
through a dense tile grid except on the ``b2sr`` word schemes, which
build one per product (small sizes only). The loop runs on the host and
syncs once per hop, on the frontier's bit count.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core import dispatch
from repro_torch.core.b2sr import combine_tiles, count_bits
from repro_torch.core.descriptor import Descriptor
from repro_torch.core.graphblas import GraphMatrix
from repro_torch.core.operands import BitVector


@dataclasses.dataclass
class KHopResult:
    reach: GraphMatrix       # R[i, j] = 1 iff j is reachable from i in <= k hops
    n_iterations: int        # mxm steps run, counting A itself (early exit)


@dispatch.scoped
def khop_reachability(g: GraphMatrix, k: int,
                      row_chunk: Optional[int] = None) -> KHopResult:
    """All-pairs <= k-hop reachability matrix by repeated masked mxm."""
    if g.n_rows != g.n_cols:
        raise ValueError("khop needs a square adjacency matrix")
    if k < 1:
        raise ValueError("k must be >= 1")
    reach = dataclasses.replace(g.b2sr, nnz=count_bits(g.b2sr.bit_tiles))
    frontier = g
    it = 1
    for _ in range(k - 1):
        visited = GraphMatrix.from_b2sr(reach, with_transpose=False,
                                        backend=g.backend)
        new = frontier.mxm(g, mask=visited, complement=True,
                           row_chunk=row_chunk, with_transpose=False)
        if new.nnz == 0:
            break
        reach = combine_tiles(reach, new.b2sr, torch.bitwise_or)
        frontier = new
        it += 1
    return KHopResult(reach=GraphMatrix.from_b2sr(reach, backend=g.backend),
                      n_iterations=it)


@dispatch.scoped
def khop_frontier(g: GraphMatrix, source: int, k: int,
                  row_chunk: Optional[int] = None) -> torch.Tensor:
    """Single-source <= k-hop neighbourhood as a bool[n] vector.

    k masked packed mxv steps over Aᵀ (BFS's step): the source seeds the
    visited set and is left out of the result, so a cycle back to it is
    not reported.
    """
    if g.bwd is None:
        raise ValueError("khop_frontier needs the transpose "
                         "(with_transpose=True)")
    n = g.n_rows
    if not 0 <= source < n:
        raise ValueError(f"source {source} outside [0, {n})")
    gt = g.transposed()
    src = torch.zeros(n, dtype=torch.float32, device=g.device)
    src[source] = 1.0
    seed = visited = frontier = BitVector.pack(src, g.tile_dim, n)
    for _ in range(k):
        frontier = gt.mxv(frontier, desc=Descriptor(
            mask=visited, complement=True, row_chunk=row_chunk))
        visited = visited | frontier
    return (visited & ~seed).unpack(torch.bool)
