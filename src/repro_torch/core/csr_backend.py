"""Dispatch-registry entries for the float-CSR baseline backend (``csr``).

The GraphBLAST/cuSPARSE stand-in: the packed operand is unpacked to
float32, multiplied on the float CSR twin and repacked. Bucketing never
applies to CSR, so every entry registers for both ``bucketed`` flags.

The dense, frontier and bitmat mxm rows are one ``torch.sparse.mm`` of
the CSR (``csr.spmm``): the frontiers unpacked to float32 ``[n, 32W]``
and the product's entries > 0 packed back, the ``BitMatrix`` words
unpacked to float32 ``[n, d]`` and the counts cast to ``out_dtype``.
The graph rows: the boolean SpGEMM returns a B2SR built from the sparse
product (``csr.mxm_bool``) and the triangle sum intersects sorted rows
(``csr.tri_sum``); both stay sparse
where the reference densifies to ``[n, n]``. The count rows return the
dense float32 counts, as the reference's do, so they are for small sizes
only.
"""

from __future__ import annotations

import torch

from repro_torch.core import csr as csr_mod
from repro_torch.core.b2sr import (pack_bitvector, pack_frontier_matrix,
                                   unpack_bitvector, unpack_frontier_matrix)
from repro_torch.core.dispatch import BOTH, apply_output_mask, register
from repro_torch.core.operands import BitMatrix
from repro_torch.core.ops import apply_frontier_mask
from repro_torch.core.semiring import ARITHMETIC


@register("mxv", "dense", "full", "csr", bucketed=BOTH, masked=False)
def _mxv_dense(g, x, call):
    return csr_mod.mxv(g.csr, x, call.semiring, call.a_value)


@register("mxv", "dense", "full", "csr", bucketed=BOTH, masked=True)
def _mxv_dense_masked(g, x, call):
    return csr_mod.mxv_masked(g.csr, x, call.mask, call.semiring,
                              call.complement, call.a_value)


@register("mxv", "bitvec", "bin", "csr", bucketed=BOTH)
def _mxv_bitvec(g, xw, call):
    t = g.tile_dim
    x = unpack_bitvector(xw, t, g.n_cols, torch.float32)
    yp = pack_bitvector(csr_mod.mxv(g.csr, x, ARITHMETIC) > 0, t, g.n_rows)
    if call.mask is not None:
        yp = yp & (~call.mask if call.complement else call.mask)
    return yp


@register("mxv_pull", "bitvec", "bin", "csr", bucketed=BOTH, masked=True)
def _mxv_pull(g, xw, call):
    # the float baseline has no early-exit schedule to switch to: the
    # pull row is the masked push row, bit-exact against the bit backends
    return _mxv_bitvec(g, xw, call)


@register("mxv", "bitvec", "full", "csr", bucketed=BOTH, masked=False)
def _mxv_count(g, xw, call):
    x = unpack_bitvector(xw, g.tile_dim, g.n_cols, torch.float32)
    return csr_mod.mxv(g.csr, x, ARITHMETIC).to(call.out_dtype)


@register("mxv", "bitvec", "full", "csr", bucketed=BOTH, masked=True)
def _mxv_count_masked(g, xw, call):
    y = _mxv_count(g, xw, call)
    return apply_output_mask(y, call.mask, call.complement,
                             torch.zeros((), dtype=call.out_dtype))


# -- mxm over dense and frontier operands --------------------------------------

@register("mxm", "dense", "full", "csr", bucketed=BOTH, masked=False)
def _mxm_dense(g, x, call):
    return csr_mod.spmm(g.csr, x)


@register("mxm", "dense", "full", "csr", bucketed=BOTH, masked=True)
def _mxm_dense_masked(g, x, call):
    y = csr_mod.spmm(g.csr, x)
    return apply_output_mask(y, call.mask, call.complement,
                             call.semiring.identity_for(y.dtype))


@register("mxm", "bitmat", "full", "csr", bucketed=BOTH, masked=False)
def _mxm_bitmat(g, xw, call):
    x = BitMatrix.from_words(xw, g.n_cols, g.tile_dim).unpack(torch.float32)
    return csr_mod.spmm(g.csr, x).to(call.out_dtype)


@register("mxm", "bitmat", "full", "csr", bucketed=BOTH, masked=True)
def _mxm_bitmat_masked(g, xw, call):
    y = _mxm_bitmat(g, xw, call)
    return apply_output_mask(y, call.mask, call.complement,
                             call.semiring.identity_for(y.dtype))


@register("mxm", "frontier", "bin", "csr", bucketed=BOTH)
def _mxm_frontier(g, fw, call):
    x = unpack_frontier_matrix(fw, g.n_cols, fw.shape[2] * 32, torch.float32)
    yp = pack_frontier_matrix(csr_mod.spmm(g.csr, x) > 0, g.tile_dim,
                              g.n_rows)
    if call.mask is not None:
        yp = apply_frontier_mask(yp, call.mask, call.complement)
    return yp


@register("mxm_pull", "frontier", "bin", "csr", bucketed=BOTH, masked=True)
def _mxm_pull(g, fw, call):
    return _mxm_frontier(g, fw, call)


# -- mxm over graph operands: Table III ---------------------------------------

@register("mxm", "graph", "bin", "csr", bucketed=BOTH)
def _mxm_graph(g, other, call):
    mask = call.mask.csr if call.mask is not None else None
    return csr_mod.mxm_bool(g.csr, other.csr, g.tile_dim, mask,
                            call.complement)


def _graph_counts(g, other):
    return csr_mod.to_sparse(g.csr) @ csr_mod.to_dense(other.csr)


@register("mxm", "graph", "full", "csr", bucketed=BOTH, masked=False)
def _mxm_graph_count(g, other, call):
    return _graph_counts(g, other)


@register("mxm", "graph", "full", "csr", bucketed=BOTH, masked=True)
def _mxm_graph_count_masked(g, other, call):
    dm = csr_mod.to_dense(call.mask.csr) > 0
    return torch.where(~dm if call.complement else dm,
                       _graph_counts(g, other), 0.0)


# -- mxm_sum: Σ mask ⊙ (A·B), tri_count's fused reduction ----------------------

@register("mxm_sum", "tri", "full", "csr", bucketed=BOTH, masked=True)
def _tri_sum(g, tri, call):
    return csr_mod.tri_sum(tri.csr)
