"""Connected components, FastSV-style linear-algebra formulation (paper §V).

min-plus label propagation with pointer jumping: every vertex repeatedly
takes the minimum label among itself and its neighbours (a min-plus mxv
with ``a_value=0``), then shortcuts through its parent, ``f ← f[f]``.

Direction is operand orientation here: a push iteration hooks over
out-edges (``A``), a pull iteration over in-edges (``Aᵀ``). On the
symmetric adjacency CC assumes, the two are the same matrix and min is
order-insensitive, so every mode gives the same labels. The changed set,
packed and popcounted, plays the frontier in the density estimate of
``repro_torch.algorithms.direction``; CC has no visited set.

Labels are float32 inside the loop, as in the reference: exact while
``n <= 2**24``. The loop runs on the host and syncs once per iteration,
on the popcount of the changed set.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

import torch

from repro_torch.algorithms import direction as direction_mod
from repro_torch.algorithms.direction import DirectionConfig
from repro_torch.core import dispatch
from repro_torch.core.descriptor import Descriptor
from repro_torch.core.graphblas import GraphMatrix
from repro_torch.core.operands import BitVector
from repro_torch.core.semiring import MIN_PLUS


@dataclasses.dataclass
class CCResult:
    labels: torch.Tensor   # int32[n]: representative (min vertex id)
    n_iterations: int
    directions: Tuple[str, ...] = ()


@dispatch.scoped
def connected_components(g: GraphMatrix, max_iters: Optional[int] = None,
                         row_chunk: Optional[int] = None,
                         direction: Union[str, DirectionConfig, None] = "auto"
                         ) -> CCResult:
    """Component labels; ``direction`` as in ``bfs``."""
    cfg = direction_mod.as_config(direction)
    n = g.n_rows
    max_iters = n if max_iters is None else int(max_iters)
    # orientation switching needs the stored transpose; without it the
    # loop hooks over A only
    if g.bwd is None and g.backend != "csr" and cfg.mode != "push":
        cfg = DirectionConfig(mode="push")
    gt = g.transposed() if cfg.mode != "push" else g
    avg_degree = g.nnz / max(n, 1)
    desc = Descriptor(row_chunk=row_chunk)

    f = torch.arange(n, dtype=torch.float32, device=g.device)
    d = direction_mod.initial_direction(cfg)
    locked = False
    trace = []
    it = 0
    live = n > 0            # the reference starts from "every label changed"
    while live and it < max_iters:
        src = gt if d == direction_mod.PULL else g
        f_new = torch.minimum(f, src.mxv(f, MIN_PLUS, desc, a_value=0.0))
        f_new = f_new[f_new.long()]             # shortcut: f[i] ← f[f[i]]
        changed = BitVector.pack(f_new != f, g.tile_dim, n)
        trace.append(d)
        nnz_changed = int(direction_mod.nnz_words(changed.words))
        d, locked = direction_mod.next_direction(cfg, d, locked, nnz_changed,
                                                 0, n, avg_degree)
        f = f_new
        it += 1
        live = nnz_changed > 0
    dirs = direction_mod.trace_tuple(trace, it)
    direction_mod.observe_trace(dirs, kernel="cc")
    return CCResult(labels=f.to(torch.int32), n_iterations=it,
                    directions=dirs)
