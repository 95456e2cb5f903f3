"""Plain PyTorch version of the boolean SpGEMM (``spgemm.cu``).

Same inputs as the wrapper: B2SR A, B and an optional mask. It unpacks
the tiles to vertex COO and pairs every entry (i, x) of A with every
entry (x, j) of B's row x, drops the pairs the mask (or its complement)
excludes, and packs what is left with ``coo_to_b2sr``, which merges
duplicates: no tile arithmetic in common with the kernel. It walks
chunks of whole tile-rows of bounded work, so it runs on the main path's
inputs too. The CPU path and the tests use it; on the card it is the
yardstick.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import csr as csr_mod
from repro_torch.core.b2sr import B2SR, b2sr_to_coo, coo_to_b2sr, stack_rows


def spgemm_bbb(a: B2SR, b: B2SR, mask: Optional[B2SR] = None, *,
               complement: bool = False) -> B2SR:
    """C⟨M⟩ (or C⟨¬M⟩) = A ∨.∧ B as a B2SR (``nnz`` = its set bits)."""
    t, dev = a.tile_dim, a.device
    ra, ca = b2sr_to_coo(a)              # grouped by tile-row
    rb, cb = b2sr_to_coo(b)
    bm = csr_mod.from_coo(rb, cb, b.n_rows, b.n_cols, device=dev)
    b_ptr, b_len = bm.row_ptr.long(), csr_mod.row_lengths(bm)
    m_keys = None
    if mask is not None:
        rm, cm = b2sr_to_coo(mask)
        m_keys = torch.sort(rm * mask.n_cols + cm).values
    work = b_len[ca]
    row_work = torch.zeros(a.n_tile_rows, dtype=torch.int64, device=dev)
    row_work.index_add_(0, ra // t, work)
    entry_start = torch.searchsorted(
        ra // t, torch.arange(a.n_tile_rows + 1, device=dev))
    pieces = []
    for tr0, tr1 in csr_mod.work_chunks(row_work):
        e0, e1 = int(entry_start[tr0]), int(entry_start[tr1])
        rep, off = csr_mod.expand(work[e0:e1], e0)
        i = ra[rep]
        j = bm.col_idx[b_ptr[ca[rep]] + off].long()
        if m_keys is not None:
            hit = csr_mod.is_in(m_keys, i * b.n_cols + j)
            keep = ~hit if complement else hit
            i, j = i[keep], j[keep]
        r0, r1 = tr0 * t, min(tr1 * t, a.n_rows)
        pieces.append(coo_to_b2sr(i - r0, j, r1 - r0, b.n_cols, t, dev))
    if not pieces:
        return coo_to_b2sr(ra[:0], ra[:0], a.n_rows, b.n_cols, t, dev)
    return stack_rows(pieces, b.n_cols, t)
