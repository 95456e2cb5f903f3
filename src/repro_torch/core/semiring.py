"""Semiring definitions for GraphBLAS-style operations (paper Table IV)."""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch


@dataclasses.dataclass(frozen=True)
class Semiring:
    """(⊕, ⊗) with the ⊕-monoid identity. ``add`` must be associative.

    ``reduce`` names the ``scatter_reduce`` mode of ⊕ (``"sum"``,
    ``"amin"``, ``"amax"``), the torch form of a segment reduction.
    """

    name: str
    add: Callable          # y = add(a, b)
    mul: Callable          # z = mul(a, b)
    add_identity: float    # identity of ⊕ (cast to the vector dtype)
    reduce: str

    def identity_for(self, dtype, device=None) -> torch.Tensor:
        return torch.tensor(self.add_identity, dtype=dtype, device=device)


# Boolean {0,1} — BFS, diameter, MIS, GC
BOOLEAN = Semiring("boolean", torch.logical_or, torch.logical_and, False,
                   "amax")
# Arithmetic (R, +, ×) — PR, TC, LGC
ARITHMETIC = Semiring("arithmetic", torch.add, torch.mul, 0.0, "sum")
# Tropical min-plus (R ∪ {+inf}, min, +) — SSSP, CC
MIN_PLUS = Semiring("min_plus", torch.minimum, torch.add, float("inf"), "amin")
# Tropical max-times (R, max, ×) — MIS, GC
MAX_TIMES = Semiring("max_times", torch.maximum, torch.mul, -float("inf"),
                     "amax")

SEMIRINGS = {s.name: s for s in (BOOLEAN, ARITHMETIC, MIN_PLUS, MAX_TIMES)}
