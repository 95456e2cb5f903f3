"""BitGNN aggregation layers: every neighbourhood sum goes through
``GraphMatrix.mxm``.

``aggregate`` dispatches the registry's ``("mxm", "dense", "full", ...)``
row and ``binary_aggregate`` the ``("mxm", "bitmat", "full", ...)`` row,
so backends and buckets apply to GNN aggregation as they do to
traversal. Each takes a port :class:`GraphMatrix` (its backend and
buckets, unless ``backend=`` or ``use_buckets=`` say otherwise) or a bare
:class:`B2SR`, which is wrapped with ``GraphMatrix.from_b2sr``; the port's
graphs are B2SR first, so the reference's ``graph_from_ell`` has no
counterpart. The rows are the adjacency's: ``y[i] = Σ_j A[i, j] x[j]``.

``axes=`` (row-sharded aggregation over a device mesh) waits for the
multi-GPU slice (ROADMAP Queue 1 item 9) and raises here.
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import torch

from repro_torch.core.b2sr import B2SR
from repro_torch.core.graphblas import GraphMatrix
from repro_torch.core.operands import BitMatrix
from repro_torch.gnn_bit import binarize as binarize_mod

Graph = Union[GraphMatrix, B2SR]


def _resolve_graph(a: Graph, axes: Sequence[str], backend: Optional[str],
                   use_buckets: Optional[bool]) -> GraphMatrix:
    if axes:
        raise NotImplementedError(
            f"sharded aggregation (axes={tuple(axes)!r}) is not ported yet "
            f"(ROADMAP Queue 1 item 9)")
    g = (a if isinstance(a, GraphMatrix)
         else GraphMatrix.from_b2sr(a, with_transpose=False))
    if backend is not None and backend != g.backend:
        g = g.with_backend(backend)
    if use_buckets is not None and use_buckets != g.use_buckets:
        g = g.with_buckets(use_buckets)
    return g


def aggregate(a: Graph, x: torch.Tensor, axes: Sequence[str] = (),
              backend: Optional[str] = None,
              use_buckets: Optional[bool] = None) -> torch.Tensor:
    """``A @ x`` through the registry's dense mxm row (the GCN product)."""
    return _resolve_graph(a, axes, backend, use_buckets).mxm(x)


def binary_aggregate(a: Graph, bm: BitMatrix, out_dtype=None,
                     axes: Sequence[str] = (), backend: Optional[str] = None,
                     use_buckets: Optional[bool] = None) -> torch.Tensor:
    """``A @ bits`` through the packed bin·bin→full row: popcount counts
    ``[n, d]`` in ``out_dtype`` (default float32)."""
    return _resolve_graph(a, axes, backend, use_buckets).mxm(
        bm, out_dtype=out_dtype)


def signed_aggregate(a: Graph, x: torch.Tensor, rowsum: torch.Tensor,
                     axes: Sequence[str] = (), backend: Optional[str] = None,
                     use_buckets: Optional[bool] = None,
                     alpha: Optional[torch.Tensor] = None) -> torch.Tensor:
    """α-scaled ±1 aggregation without unpacking the activations.

    ``A @ (α·sign(x)) = α · (2·(A @ bits) − A·1)`` with ``bits = x > 0``:
    one packed popcount mxm and a rank-1 epilogue (XNOR-Net style). Exact
    whenever ``x`` is already ±1. ``rowsum`` is A's row sum (neighbours
    per node); α defaults to the per-feature mean|x|.
    """
    g = _resolve_graph(a, axes, backend, use_buckets)
    if alpha is None:
        alpha = binarize_mod.alpha_scale(x)
    counts = binary_aggregate(g, binarize_mod.pack_activations(x,
                                                               g.tile_dim))
    return alpha[None, :] * (2.0 * counts - rowsum[:, None])
