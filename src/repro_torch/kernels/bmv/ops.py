"""Dispatch-registry entries: the ``b2sr_cuda`` mxv rows.

Every kernel walks the CSR-over-tiles arrays of ``g.b2sr`` directly, so
one function serves ``bucketed`` True and False (the bucketed slabs were
a TPU static-shape device) and ``row_chunk`` is ignored, as the
reference's ``b2sr_pallas`` rows ignore it: the outputs are the same.
The dense and count rows apply a mask after the kernel, as the
reference's rows do; every row passes the work items kept with the
stored orientation (``kernels/items.py``; push, pull and count share
one cut), and the pull row the tile-rows' lane occupancy kept beside
them. Operands are made contiguous here:
the kernels take dense arrays only.
"""

from __future__ import annotations

import torch

from repro_torch.core.dispatch import BOTH, apply_output_mask, register
from repro_torch.core.ops import bff_setup
from repro_torch.kernels.bmv.bmv import (BBF_ITEM_WORK, BFF_ITEM_WORK,
                                         bmv_bbb_pull, bmv_bbb_push, bmv_bbf,
                                         bmv_bff)
from repro_torch.kernels.items import items_for, lanes_for

#: semiring name -> ``bmv_bff`` mode; the boolean semiring has no kernel
#: path, as in the reference's ``b2sr_pallas`` row
_MODE = {"arithmetic": "sum", "min_plus": "min_plus",
         "max_times": "max_times"}


@register("mxv", "bitvec", "bin", "b2sr_cuda", bucketed=BOTH, masked=BOTH)
def _mxv_bitvec(g, xw, call):
    m = g.b2sr
    mask = None if call.mask is None else call.mask.contiguous()
    return bmv_bbb_push(m.tile_row_ptr, m.tile_col_idx, m.bit_tiles,
                        xw.contiguous(), mask, t=m.tile_dim,
                        complement=call.complement or call.mask is None,
                        items=items_for(g, BBF_ITEM_WORK))


@register("mxv_pull", "bitvec", "bin", "b2sr_cuda", bucketed=BOTH,
          masked=True)
def _mxv_pull(g, xw, call):
    m = g.b2sr
    return bmv_bbb_pull(m.tile_row_ptr, m.tile_col_idx, m.bit_tiles,
                        xw.contiguous(), call.mask.contiguous(),
                        t=m.tile_dim, complement=call.complement,
                        items=items_for(g, BBF_ITEM_WORK),
                        lanes=lanes_for(g))


@register("mxv", "dense", "full", "b2sr_cuda", bucketed=BOTH, masked=BOTH)
def _mxv_dense(g, x, call):
    sr = call.semiring
    if sr.name not in _MODE:
        raise NotImplementedError(f"kernel path for semiring {sr.name}")
    m = g.b2sr
    t = m.tile_dim
    x3, ident, _ = bff_setup(g.n_cols, t, x, sr, call.a_value)
    y = bmv_bff(m.tile_row_ptr, m.tile_col_idx, m.bit_tiles, x3, t=t,
                mode=_MODE[sr.name], a_value=call.a_value,
                items=items_for(g, BFF_ITEM_WORK, by_bits=True))[: g.n_rows]
    if call.mask is None:
        return y
    return apply_output_mask(y, call.mask, call.complement, ident)


@register("mxv", "bitvec", "full", "b2sr_cuda", bucketed=BOTH, masked=BOTH)
def _mxv_count(g, xw, call):
    m = g.b2sr
    y = bmv_bbf(m.tile_row_ptr, m.tile_col_idx, m.bit_tiles, xw.contiguous(),
                t=m.tile_dim,
                items=items_for(g, BBF_ITEM_WORK))[: g.n_rows].to(
                    call.out_dtype)
    if call.mask is None:
        return y
    return apply_output_mask(y, call.mask, call.complement,
                             torch.zeros((), dtype=call.out_dtype))
