"""Triangle counting: Σ (L·Lᵀ ⊙ L) with the fused masked product (paper §V).

As in GraphBLAST (Azad-Buluç/Wolf): L is the strict lower triangle of the
symmetric adjacency, and the mask fuses the element-wise product and the
global sum into the product: the ``mxm_sum`` registry row behind
``GraphMatrix.tri_count``, whose L is built once and memoized.
"""

from __future__ import annotations

from typing import Optional

from repro_torch.core import dispatch
from repro_torch.core.graphblas import GraphMatrix


@dispatch.scoped
def triangle_count(g: GraphMatrix, row_chunk: Optional[int] = None) -> int:
    """Number of triangles in the undirected graph of ``g`` (exact)."""
    return int(g.tri_count(row_chunk=row_chunk))
