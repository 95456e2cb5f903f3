"""Plain PyTorch version of the masked product reduction (``bmm.cu``).

Same inputs as the wrapper: B2SR A, Bᵀ and the mask. It unpacks the
tiles to vertex COO and intersects rows, Σ over the mask's entries (r, c)
of |row r of A ∩ row c of Bᵀ| (``csr.masked_dot_sum``): no tile
arithmetic in common with the kernel, and a walk in chunks of bounded
work, so it runs on the main path's inputs too (L of R-MAT scale 21).
The CPU path and the tests use it; on the card it is the yardstick.
"""

from __future__ import annotations

import torch

from repro_torch.core import csr as csr_mod
from repro_torch.core.b2sr import B2SR, b2sr_to_coo


def _csr(m: B2SR) -> csr_mod.CSRMatrix:
    rows, cols = b2sr_to_coo(m)
    return csr_mod.from_coo(rows, cols, m.n_rows, m.n_cols, device=m.device)


def bmm_tc(a: B2SR, bt: B2SR, mask: B2SR) -> torch.Tensor:
    """Σ mask ⊙ (A·B), B given as Bᵀ: an int64 scalar tensor."""
    rows, cols = b2sr_to_coo(mask)
    return csr_mod.masked_dot_sum(_csr(a), _csr(bt), rows, cols)
