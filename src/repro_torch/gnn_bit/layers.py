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

``axes=`` aggregates through the registry's sharded rows: the graph is
row-partitioned once over a mesh (:func:`prepare_sharded`, kept in a
cache by the adjacency's identity and the axes), and every later call
with the same axes finds it. A call whose graph is not prepared prepares
it over the default mesh (every visible CUDA device on the first axis).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple, Union

import torch

from repro_torch.core.b2sr import B2SR
from repro_torch.core.graphblas import GraphMatrix
from repro_torch.core.mesh import make_mesh
from repro_torch.core.operands import BitMatrix
from repro_torch.gnn_bit import binarize as binarize_mod

Graph = Union[GraphMatrix, B2SR]


def _as_graph(a: Graph, backend: Optional[str],
              use_buckets: Optional[bool]) -> GraphMatrix:
    g = (a if isinstance(a, GraphMatrix)
         else GraphMatrix.from_b2sr(a, with_transpose=False))
    if backend is not None and backend != g.backend:
        g = g.with_backend(backend)
    if use_buckets is not None and use_buckets != g.use_buckets:
        g = g.with_buckets(use_buckets)
    return g


# -- prepared sharded graphs -----------------------------------------------

_SHARDED_CACHE: Dict[tuple, GraphMatrix] = {}


def _signature(a: Graph, axes: Tuple[str, ...], backend: Optional[str],
               use_buckets: Optional[bool]) -> tuple:
    """The adjacency's identity (its arrays' storage, shape and device)
    with the axes, the backend and the bucket flag it aggregates on."""
    g = a if isinstance(a, GraphMatrix) else None
    m = a.b2sr if g is not None else a
    backend = backend or (g.backend if g is not None else "b2sr")
    if use_buckets is None:
        use_buckets = g.use_buckets if g is not None else True
    return (m.tile_dim, m.n_rows, m.n_cols, m.n_tiles, str(m.device),
            m.tile_row_ptr.data_ptr(), m.tile_col_idx.data_ptr(),
            m.bit_tiles.data_ptr(), axes, backend, use_buckets)


def prepare_sharded(graph: Graph, axes: Sequence[str], mesh=None,
                    backend: Optional[str] = None,
                    use_buckets: Optional[bool] = None) -> GraphMatrix:
    """Row-partition ``graph`` over ``mesh`` once; later aggregations with
    the same ``axes`` find it. ``mesh`` defaults to every visible CUDA
    device on the first axis name (the other axes of size 1)."""
    axes = tuple(axes)
    if mesh is None:
        mesh = make_mesh((-1,) + (1,) * (len(axes) - 1), axes)
    g = _as_graph(graph, backend, use_buckets)
    gs = g if g.sharded else g.shard(mesh, axes)
    _SHARDED_CACHE[_signature(graph, axes, backend, use_buckets)] = gs
    return gs


def _resolve_graph(a: Graph, axes: Sequence[str], backend: Optional[str],
                   use_buckets: Optional[bool]) -> GraphMatrix:
    if axes and not (isinstance(a, GraphMatrix) and a.sharded):
        g = _SHARDED_CACHE.get(_signature(a, tuple(axes), backend,
                                          use_buckets))
        return g if g is not None else prepare_sharded(
            a, axes, backend=backend, use_buckets=use_buckets)
    return _as_graph(a, backend, use_buckets)


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
