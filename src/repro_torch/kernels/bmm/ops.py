"""Dispatch-registry entry: the ``b2sr_cuda`` triangle-sum row.

``tri_count``'s ``mxm_sum`` row runs the fused kernel on L read three
ways (A = mask = L, Bᵀ = L), with the kernel's plan (the mask's tiles
split by the shorter row) kept with L. Bucketing does not apply to the
kernel, so both flags land on the same function, as in the reference's
``b2sr_pallas`` row; ``row_chunk`` is ignored there too.
"""

from __future__ import annotations

from repro_torch.core.dispatch import BOTH, register
from repro_torch.kernels.bmm.bmm import bmm_tc, tc_plan


@register("mxm_sum", "tri", "full", "b2sr_cuda", bucketed=BOTH, masked=True)
def _tri_sum(g, tri, call):
    lower = tri.b2sr
    if lower.device.type != "cuda":         # the plain version needs no plan
        return bmm_tc(lower, lower, lower)
    if "bmm_tc_plan" not in tri.cache:      # kept with the memoized L
        tri.cache["bmm_tc_plan"] = tc_plan(lower, lower, lower)
    return bmm_tc(lower, lower, lower, plan=tri.cache["bmm_tc_plan"])
