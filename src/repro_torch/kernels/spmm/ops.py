"""Dispatch-registry entries: the ``b2sr_cuda`` SpMM rows.

  mxm dense full        ``spmm_dense`` (masked: the mask after the
                        kernel, as the reference's rows do)
  mxm bitmat full       ``spmm_bbf`` (masked: the mask after the kernel)
  mxm frontier bin      ``spmm_bbb``, the mask ANDed in the kernel
  mxm_pull frontier bin the masked push kernel, as in the reference: a
                        row's early exit would need every one of the S
                        sources' allowed bits set, which mixed-depth
                        batches rarely reach (DESIGN.md §12)

The kernels walk ``g.b2sr`` directly, so one function serves
``bucketed`` True and False, and ``row_chunk`` is ignored, as the
reference's ``b2sr_pallas`` rows ignore it. Each kernel's work items are
cut once per stored orientation and kept with it.
"""

from __future__ import annotations

from repro_torch.core.dispatch import BOTH, apply_output_mask, register
from repro_torch.kernels.spmm.spmm import (BBB_ITEM_WORK, BBF_ITEM_WORK,
                                           DENSE_ITEM_WORK, spmm_bbb,
                                           spmm_bbf, spmm_dense, work_items)


def _items(g, budget: int, by_bits: bool = False):
    """The work items of ``g``'s B2SR for this cut, kept with it (kernels
    that cut alike share them)."""
    cache = g.fwd.cache
    key = ("work_items", budget, by_bits)
    if key not in cache:
        cache[key] = work_items(g.b2sr, budget, by_bits)
    return cache[key]


@register("mxm", "dense", "full", "b2sr_cuda", bucketed=BOTH, masked=BOTH)
def _mxm_dense(g, x, call):
    y = spmm_dense(g.b2sr, x,
                   items=_items(g, DENSE_ITEM_WORK, by_bits=True))
    if call.mask is None:
        return y
    return apply_output_mask(y, call.mask, call.complement,
                             call.semiring.identity_for(y.dtype))


@register("mxm", "bitmat", "full", "b2sr_cuda", bucketed=BOTH, masked=BOTH)
def _mxm_bitmat(g, xw, call):
    y = spmm_bbf(g.b2sr, xw, call.out_dtype,
                 items=_items(g, BBF_ITEM_WORK))
    if call.mask is None:
        return y
    return apply_output_mask(y, call.mask, call.complement,
                             call.semiring.identity_for(y.dtype))


def _frontier(g, fw, call):
    return spmm_bbb(g.b2sr, fw, call.mask, complement=call.complement,
                    items=_items(g, BBB_ITEM_WORK))


register("mxm", "frontier", "bin", "b2sr_cuda", bucketed=BOTH,
         masked=BOTH)(_frontier)
register("mxm_pull", "frontier", "bin", "b2sr_cuda", bucketed=BOTH,
         masked=True)(_frontier)
