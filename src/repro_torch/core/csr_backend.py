"""Dispatch-registry entries for the float-CSR baseline backend (``csr``).

The GraphBLAST/cuSPARSE stand-in: the packed operand is unpacked to
float32, multiplied on the float CSR twin and repacked. Bucketing never
applies to CSR, so every entry registers for both ``bucketed`` flags.
"""

from __future__ import annotations

import torch

from repro_torch.core import csr as csr_mod
from repro_torch.core.b2sr import pack_bitvector, unpack_bitvector
from repro_torch.core.dispatch import BOTH, apply_output_mask, register
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
