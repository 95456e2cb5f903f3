"""Plain PyTorch versions of the SpMM kernels (``spmm.cu``).

Same inputs as the CUDA wrappers in ``spmm.py``. The CPU path and the
tests use them; on the card they are only the yardstick the kernels are
held to. Both expand A's set bits to COO (``b2sr_to_coo``) and add rows
of the right side into the output with ``index_add_``, ``EDGE_CHUNK``
edges at a time, so nothing shares the kernels' tile arithmetic:

  spmm_bbb    unpack F to 0/1 counts ``[n_cols, 32W]``, add them up per
              output row, pack the entries that are > 0, then apply the
              mask: the reference oracle's "unpack, multiply, re-pack".
  spmm_dense  ``Y = A · X`` summed in float64 and rounded to float32 once,
              so it is the float32 rounding of a nearly exact sum.
  spmm_bbf    unpack the ``BitMatrix`` words to 0/1 ``[n_cols, D]`` and
              add them up per output row in int64: the counts.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.b2sr import (B2SR, SOURCE_WORD_BITS, b2sr_to_coo,
                                   pack_frontier_matrix,
                                   unpack_frontier_matrix)
from repro_torch.core.operands import BitMatrix

EDGE_CHUNK = 1 << 20


def _edge_chunks(m: B2SR):
    rows, cols = b2sr_to_coo(m)
    for s in range(0, rows.shape[0], EDGE_CHUNK):
        yield rows[s:s + EDGE_CHUNK], cols[s:s + EDGE_CHUNK]


def spmm_bbb(m: B2SR, f: torch.Tensor, mask: Optional[torch.Tensor] = None,
             *, complement: bool = True) -> torch.Tensor:
    """``Y = A ∨.∧ F`` over packed frontiers ``int32[C, t, W]``, then
    ``& ~mask`` (or ``& mask``): ``int32[R, t, W]``."""
    s_pad = f.shape[2] * SOURCE_WORD_BITS
    fb = unpack_frontier_matrix(f, m.n_cols, s_pad, torch.int32)
    counts = torch.zeros((m.n_rows, s_pad), dtype=torch.int32,
                         device=f.device)
    for rows, cols in _edge_chunks(m):
        counts.index_add_(0, rows, fb[cols])
    y = pack_frontier_matrix(counts > 0, m.tile_dim, m.n_rows)
    if mask is None:
        return y
    return y & (~mask if complement else mask)


def spmm_dense(m: B2SR, x: torch.Tensor) -> torch.Tensor:
    """``Y = A · X`` for dense ``x`` ``[n_cols, D]``: ``[n_rows, D]`` in
    ``x``'s dtype, summed in float64."""
    y = torch.zeros((m.n_rows, x.shape[1]), dtype=torch.float64,
                    device=x.device)
    for rows, cols in _edge_chunks(m):
        y.index_add_(0, rows, x[cols].to(torch.float64))
    return y.to(x.dtype)


def spmm_bbf(m: B2SR, xw: torch.Tensor,
             out_dtype=torch.float32) -> torch.Tensor:
    """Counts ``Y = A · unpack(xw)`` for ``BitMatrix`` words ``xw``
    ``int32[n_tile_cols, D]``: ``[n_rows, D]`` in ``out_dtype``."""
    x = BitMatrix.from_words(xw, m.n_cols, m.tile_dim).unpack(torch.int64)
    y = torch.zeros((m.n_rows, x.shape[1]), dtype=torch.int64,
                    device=xw.device)
    for rows, cols in _edge_chunks(m):
        y.index_add_(0, rows, x[cols])
    return y.to(out_dtype)
