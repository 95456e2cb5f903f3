"""Plain PyTorch versions of the boolean B2SR mxv kernels (``bmv.cu``).

Same signature and inputs as the CUDA wrappers in ``bmv.py``: the
CSR-over-tiles arrays, the packed frontier ``x`` and the packed ``mask``
(int32 bit patterns). They gather ``x[tile_col_idx]``, test
``(tile & xw) != 0`` per bit-row, OR the hit bits of each tile-row with
``scatter_reduce("amax")``, pack, then apply the mask. The CPU path and
the tests use them; on the card they are only the yardstick the kernels
are held to.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.words import lane_mask, pack_bits


def _row_hits(tile_row_ptr: torch.Tensor, tile_col_idx: torch.Tensor,
              bit_tiles: torch.Tensor, x: torch.Tensor, t: int) -> torch.Tensor:
    """Packed OR over each tile-row of ``(tile & x[col]) != 0``: int32[R]."""
    n_rows = tile_row_ptr.shape[0] - 1
    counts = (tile_row_ptr[1:] - tile_row_ptr[:-1]).long()
    tr = torch.repeat_interleave(
        torch.arange(n_rows, device=x.device), counts)
    xw = x[tile_col_idx.long()]
    hit = ((bit_tiles & xw.unsqueeze(-1)) != 0).to(torch.int32)   # [nT, t]
    rows = torch.zeros((n_rows, t), dtype=torch.int32, device=x.device)
    rows = rows.scatter_reduce(0, tr.unsqueeze(-1).expand(-1, t), hit, "amax")
    return pack_bits(rows)


def bmv_bbb_push(tile_row_ptr: torch.Tensor, tile_col_idx: torch.Tensor,
                 bit_tiles: torch.Tensor, x: torch.Tensor,
                 mask: Optional[torch.Tensor], *, t: int,
                 complement: bool = True) -> torch.Tensor:
    """Push step: hit words ANDed with ``~mask`` (or ``mask``) at the store;
    ``mask=None`` keeps every lane."""
    y = _row_hits(tile_row_ptr, tile_col_idx, bit_tiles, x, t)
    if mask is None:
        return y
    return y & (~mask if complement else mask)


def bmv_bbb_pull(tile_row_ptr: torch.Tensor, tile_col_idx: torch.Tensor,
                 bit_tiles: torch.Tensor, x: torch.Tensor, mask: torch.Tensor,
                 *, t: int, complement: bool = True) -> torch.Tensor:
    """Pull step: hits restricted to the allowed lanes,
    ``(~mask or mask) & lanes``. Equal to push by construction."""
    allowed = (~mask if complement else mask) & lane_mask(t)
    return _row_hits(tile_row_ptr, tile_col_idx, bit_tiles, x, t) & allowed
