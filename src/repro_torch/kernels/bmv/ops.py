"""Dispatch-registry entries: the ``b2sr_cuda`` mxv rows.

Both kernels walk the CSR-over-tiles arrays of ``g.b2sr`` directly, so
one function serves ``bucketed`` True and False (the bucketed slabs were
a TPU static-shape device) and ``row_chunk`` is ignored, as the
reference's ``b2sr_pallas`` rows ignore it: the outputs are the same.
"""

from __future__ import annotations

from repro_torch.core.dispatch import BOTH, pending, register
from repro_torch.kernels.bmv.bmv import bmv_bbb_pull, bmv_bbb_push


@register("mxv", "bitvec", "bin", "b2sr_cuda", bucketed=BOTH, masked=BOTH)
def _mxv_bitvec(g, xw, call):
    m = g.b2sr
    return bmv_bbb_push(m.tile_row_ptr, m.tile_col_idx, m.bit_tiles, xw,
                        call.mask, t=m.tile_dim,
                        complement=call.complement or call.mask is None)


@register("mxv_pull", "bitvec", "bin", "b2sr_cuda", bucketed=BOTH,
          masked=True)
def _mxv_pull(g, xw, call):
    m = g.b2sr
    return bmv_bbb_pull(m.tile_row_ptr, m.tile_col_idx, m.bit_tiles, xw,
                        call.mask, t=m.tile_dim, complement=call.complement)


pending("mxv", "dense", "full", "b2sr_cuda",
        "kernel bmv_bin_full_full_pallas, ROADMAP Queue 2 item 3")
pending("mxv", "bitvec", "full", "b2sr_cuda",
        "kernel bmv_bin_bin_full_pallas, ROADMAP Queue 2 item 4")
