"""PageRank and personalized PageRank on the arithmetic semiring (paper §V).

The column-stochastic product is ``Aᵀ · (pr / outdeg)``: each rank entry
is divided by its out-degree *before* the binary mxv, which keeps the
matrix binary. Dangling mass is redistributed (uniformly for PageRank,
into the restart distribution for PPR); parameters default to the
paper's (alpha 0.85, 10 iterations, eps 1e-9).

The reference runs one ``lax.while_loop``; here the loop runs on the host
and reads ``delta`` once per iteration.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Union

import numpy as np
import torch

from repro_torch.core import dispatch
from repro_torch.core.descriptor import Descriptor
from repro_torch.core.graphblas import GraphMatrix
from repro_torch.core.semiring import ARITHMETIC


@dataclasses.dataclass
class PageRankResult:
    ranks: torch.Tensor   # float32[n]
    n_iterations: int


def _power_iteration(g: GraphMatrix, pr: torch.Tensor,
                     update: Callable, max_iters: int, eps: float,
                     row_chunk: Optional[int]) -> PageRankResult:
    """Iterate ``pr ← update(pr, Aᵀ(pr/outdeg), dangling mass)`` while the
    L1 change exceeds ``eps`` (float32, as the reference compares)."""
    gt = g.transposed()
    out_deg = g.degrees()
    dangling = out_deg == 0
    safe_deg = torch.where(dangling, 1.0, out_deg)
    desc = Descriptor(row_chunk=row_chunk)
    delta = float("inf")
    it = 0
    while delta > np.float32(eps) and it < max_iters:
        contrib = gt.mxv(pr / safe_deg, ARITHMETIC, desc)
        dangle_mass = torch.where(dangling, pr, 0.0).sum()
        new = update(pr, contrib, dangle_mass)
        delta = float(torch.abs(new - pr).sum())
        pr = new
        it += 1
    return PageRankResult(ranks=pr, n_iterations=it)


@dispatch.scoped
def pagerank(g: GraphMatrix, alpha: float = 0.85, max_iters: int = 10,
             eps: float = 1e-9,
             row_chunk: Optional[int] = None) -> PageRankResult:
    """Global PageRank from the uniform distribution."""
    n = g.n_rows

    def update(pr, contrib, dangle_mass):
        return alpha * (contrib + dangle_mass / n) + (1.0 - alpha) / n

    pr0 = torch.full((n,), 1.0 / n, dtype=torch.float32, device=g.device)
    return _power_iteration(g, pr0, update, max_iters, eps, row_chunk)


@dispatch.scoped
def ppr(g: GraphMatrix, seed: Union[int, torch.Tensor, np.ndarray],
        alpha: float = 0.85, max_iters: int = 10, eps: float = 1e-9,
        row_chunk: Optional[int] = None) -> PageRankResult:
    """Personalized PageRank: teleport to ``seed`` instead of uniformly.

    ``seed`` is a node id (one-hot restart) or a restart distribution
    ``[n]``. Dangling mass restarts into the same distribution:

        pr' = α·Aᵀ(pr/outdeg) + (α·dangling_mass + 1 − α)·r
    """
    n = g.n_rows
    if np.ndim(seed) == 0:
        if not 0 <= int(seed) < n:
            raise ValueError(f"seed {int(seed)} out of range [0, {n})")
        r = torch.zeros(n, dtype=torch.float32, device=g.device)
        r[int(seed)] = 1.0
    else:
        r = torch.as_tensor(seed, dtype=torch.float32, device=g.device)
        if r.shape != (n,):
            raise ValueError(f"restart vector must have shape ({n},)")

    def update(pr, contrib, dangle_mass):
        return alpha * contrib + (alpha * dangle_mass + (1.0 - alpha)) * r

    return _power_iteration(g, r, update, max_iters, eps, row_chunk)
