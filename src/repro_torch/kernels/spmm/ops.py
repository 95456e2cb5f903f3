"""Dispatch-registry entries: the ``b2sr_cuda`` SpMM rows.

  mxm dense full        ``spmm_dense`` (masked: the mask after the
                        kernel, as the reference's rows do)
  mxm frontier bin      ``spmm_bbb``, the mask ANDed in the kernel
  mxm_pull frontier bin the masked push kernel, as in the reference: a
                        row's early exit would need every one of the S
                        sources' allowed bits set, which mixed-depth
                        batches rarely reach (DESIGN.md §12)

Both kernels walk ``g.b2sr`` directly, so one function serves
``bucketed`` True and False, and ``row_chunk`` is ignored, as the
reference's ``b2sr_pallas`` rows ignore it. Each kernel's work items are
cut once per stored orientation and kept with it.
"""

from __future__ import annotations

from repro_torch.core.dispatch import BOTH, apply_output_mask, register
from repro_torch.kernels.spmm.spmm import (BBB_ITEM_WORK, DENSE_ITEM_WORK,
                                           spmm_bbb, spmm_dense, work_items)


def _items(g, name: str, budget: int, by_bits: bool = False):
    cache = g.fwd.cache
    if name not in cache:
        cache[name] = work_items(g.b2sr, budget, by_bits)
    return cache[name]


@register("mxm", "dense", "full", "b2sr_cuda", bucketed=BOTH, masked=BOTH)
def _mxm_dense(g, x, call):
    y = spmm_dense(g.b2sr, x, items=_items(g, "spmm_dense", DENSE_ITEM_WORK,
                                           by_bits=True))
    if call.mask is None:
        return y
    return apply_output_mask(y, call.mask, call.complement,
                             call.semiring.identity_for(y.dtype))


def _frontier(g, fw, call):
    return spmm_bbb(g.b2sr, fw, call.mask, complement=call.complement,
                    items=_items(g, "spmm_bbb", BBB_ITEM_WORK))


register("mxm", "frontier", "bin", "b2sr_cuda", bucketed=BOTH,
         masked=BOTH)(_frontier)
register("mxm_pull", "frontier", "bin", "b2sr_cuda", bucketed=BOTH,
         masked=True)(_frontier)
