"""Dispatch-registry entries: the ``b2sr_cuda`` SpMM rows.

  mxm dense full        ``spmm_dense`` (masked: the mask after the
                        kernel, as the reference's rows do); the
                        gradient in X is ``spmm_dense`` over Aᵀ: the
                        stored transpose, or one built from the tiles
                        on the first backward and kept with A
  mxm bitmat full       ``spmm_bbf`` (masked: the mask after the kernel)
  mxm frontier bin      ``spmm_bbb``, the mask ANDed in the kernel
  mxm_pull frontier bin the masked push kernel, as in the reference: a
                        row's early exit would need every one of the S
                        sources' allowed bits set, which mixed-depth
                        batches rarely reach (DESIGN.md §12)

The kernels walk ``g.b2sr`` directly, so one function serves
``bucketed`` True and False, and ``row_chunk`` is ignored, as the
reference's ``b2sr_pallas`` rows ignore it. Each kernel's work items are
cut once per stored orientation and kept with it
(``kernels/items.py``). Operands are made contiguous here: the kernels
take dense row-major arrays only.
"""

from __future__ import annotations

import torch

from repro_torch.core import b2sr as b2sr_mod
from repro_torch.core.dispatch import BOTH, apply_output_mask, register
from repro_torch.kernels.items import items_for
from repro_torch.kernels.spmm.spmm import (BBB_ITEM_WORK, BBF_ITEM_WORK,
                                           DENSE_ITEM_WORK, spmm_bbb,
                                           spmm_bbf, spmm_dense)


def _dense_items(g):
    return items_for(g, DENSE_ITEM_WORK, by_bits=True)


def _transposed(g):
    """Aᵀ for the gradient: the stored transpose, or, for a graph built
    without one, ``b2sr.transpose`` of A's tiles, built once and kept in
    A's orientation cache (its work items are then kept with it)."""
    if g.bwd is not None:
        return g.transposed()
    cache = g.fwd.cache
    if "transpose" not in cache:
        from repro_torch.core.graphblas import GraphMatrix
        cache["transpose"] = GraphMatrix.from_b2sr(
            b2sr_mod.transpose(g.b2sr), with_transpose=False,
            backend=g.backend)
    return cache["transpose"]


class _DenseProduct(torch.autograd.Function):
    """``Y = A · X`` through ``spmm_dense``, differentiable in ``X``: the
    gradient ``Aᵀ · dY`` runs the same kernel over Aᵀ (:func:`_transposed`,
    with the work items it keeps). On a CPU graph both directions run the
    plain version."""

    @staticmethod
    def forward(ctx, g, x):
        ctx.g = g
        return spmm_dense(g.b2sr, x, items=_dense_items(g))

    @staticmethod
    def backward(ctx, dy):
        gt = _transposed(ctx.g)
        return None, spmm_dense(gt.b2sr, dy.contiguous(),
                                items=_dense_items(gt))


@register("mxm", "dense", "full", "b2sr_cuda", bucketed=BOTH, masked=BOTH)
def _mxm_dense(g, x, call):
    y = _DenseProduct.apply(g, x.contiguous())
    if call.mask is None:
        return y
    return apply_output_mask(y, call.mask, call.complement,
                             call.semiring.identity_for(y.dtype))


@register("mxm", "bitmat", "full", "b2sr_cuda", bucketed=BOTH, masked=BOTH)
def _mxm_bitmat(g, xw, call):
    y = spmm_bbf(g.b2sr, xw.contiguous(), call.out_dtype,
                 items=items_for(g, BBF_ITEM_WORK))
    if call.mask is None:
        return y
    return apply_output_mask(y, call.mask, call.complement,
                             call.semiring.identity_for(y.dtype))


def _frontier(g, fw, call):
    mask = None if call.mask is None else call.mask.contiguous()
    return spmm_bbb(g.b2sr, fw.contiguous(), mask,
                    complement=call.complement,
                    items=items_for(g, BBB_ITEM_WORK))


register("mxm", "frontier", "bin", "b2sr_cuda", bucketed=BOTH,
         masked=BOTH)(_frontier)
register("mxm_pull", "frontier", "bin", "b2sr_cuda", bucketed=BOTH,
         masked=True)(_frontier)
