"""Dispatch-registry entries: the ``b2sr_cuda`` SpGEMM rows.

The boolean rows launch ``spgemm_bbb`` on the CSR-over-tiles arrays for
``bucketed`` True and False alike (the bucketed slabs were a TPU
static-shape device) and return its B2SR; ``row_chunk`` is ignored, as in
the reference's ``b2sr_pallas`` rows. The count rows have no kernel in
the reference either: they register the torch word schemes, as the
reference's ``b2sr_pallas`` registers its jnp ones.
"""

from __future__ import annotations

from repro_torch.core.dispatch import BOTH, register
from repro_torch.core.ops import mxm_count
from repro_torch.kernels.spgemm.spgemm import spgemm_bbb


@register("mxm", "graph", "bin", "b2sr_cuda", bucketed=BOTH)
def _mxm_graph(g, other, call):
    mask = call.mask.b2sr if call.mask is not None else None
    return spgemm_bbb(g.b2sr, other.b2sr, mask, complement=call.complement)


@register("mxm", "graph", "full", "b2sr_cuda", bucketed=False)
def _mxm_graph_count(g, other, call):
    return mxm_count(g, other, call, bucketed=False)


@register("mxm", "graph", "full", "b2sr_cuda", bucketed=True)
def _mxm_graph_count_bucketed(g, other, call):
    return mxm_count(g, other, call, bucketed=True)
