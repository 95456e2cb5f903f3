"""Plain PyTorch versions of the B2SR mxv kernels (``bmv.cu``).

Same signature and inputs as the CUDA wrappers in ``bmv.py``: the
CSR-over-tiles arrays, then the packed frontier ``x`` and ``mask`` (int32
bit patterns) or the dense ``x3`` tiles. The CPU path and the tests use
them; on the card they are only the yardstick the kernels are held to.

  bmv_bbb_push / _pull  gather ``x[tile_col_idx]``, test
                        ``(tile & xw) != 0`` per bit-row, OR the hit bits
                        of each tile-row with ``scatter_reduce("amax")``,
                        pack, then apply the mask.
  bmv_bff               unpack each tile's bits, ⊕-reduce
                        ``a_value ⊗ x3[col]`` over the set bits of each
                        bit-row, then ``scatter_reduce`` by tile-row from
                        the ⊕-identity; the sum mode accumulates in
                        float64, so its result is the float32 rounding of
                        a nearly exact sum.
  bmv_bbf               ``popcount(tile & x[col])`` per bit-row, added by
                        tile-row with ``index_add_``.

The last two work through ``chunk_words`` tile bits at a time: unpacking
every tile of a Graph500-size graph at once would take ``nT * t * t``
bytes (135 GB at R-MAT scale 21, t = 32).
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.words import lane_mask, pack_bits, popcount, unpack_bits

CHUNK_WORDS = 1 << 26

#: bmv_bff modes: (⊕-identity, ⊗, ``scatter_reduce`` name of ⊕)
BFF_MODES = {
    "sum": (0.0, torch.mul, "sum"),
    "min_plus": (float("inf"), torch.add, "amin"),
    "max_times": (-float("inf"), torch.mul, "amax"),
}


def _tile_rows(tile_row_ptr: torch.Tensor) -> torch.Tensor:
    """Tile-row index of every stored tile (int64[nT])."""
    counts = (tile_row_ptr[1:] - tile_row_ptr[:-1]).long()
    return torch.repeat_interleave(
        torch.arange(counts.shape[0], device=tile_row_ptr.device), counts)


def _row_hits(tile_row_ptr: torch.Tensor, tile_col_idx: torch.Tensor,
              bit_tiles: torch.Tensor, x: torch.Tensor, t: int) -> torch.Tensor:
    """Packed OR over each tile-row of ``(tile & x[col]) != 0``: int32[R]."""
    n_rows = tile_row_ptr.shape[0] - 1
    tr = _tile_rows(tile_row_ptr)
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


def bmv_bff(tile_row_ptr: torch.Tensor, tile_col_idx: torch.Tensor,
            bit_tiles: torch.Tensor, x3: torch.Tensor, *, t: int, mode: str,
            a_value: float = 1.0,
            chunk_words: int = CHUNK_WORDS) -> torch.Tensor:
    """Semiring mxv, select form: ``[R * t]`` in ``x3``'s dtype."""
    ident, mul, reduce = BFF_MODES[mode]
    acc_dtype = torch.float64 if mode == "sum" else x3.dtype
    tr = _tile_rows(tile_row_ptr)
    out = torch.full((tile_row_ptr.shape[0] - 1, t), ident, dtype=acc_dtype,
                     device=x3.device)
    av = torch.tensor(a_value, dtype=x3.dtype, device=x3.device)
    step = max(1, chunk_words // (t * t))
    for s in range(0, tile_col_idx.shape[0], step):
        bits = unpack_bits(bit_tiles[s:s + step], t)          # [n, t, t]
        prod = mul(av, x3[tile_col_idx[s:s + step].long()])   # [n, t]
        contrib = torch.where(bits, prod.to(acc_dtype).unsqueeze(1), ident)
        part = getattr(contrib, reduce)(dim=2)                # [n, t]
        rows = tr[s:s + step].unsqueeze(-1).expand(-1, t)
        out.scatter_reduce_(0, rows, part, reduce, include_self=True)
    return out.to(x3.dtype).reshape(-1)


def bmv_bbf(tile_row_ptr: torch.Tensor, tile_col_idx: torch.Tensor,
            bit_tiles: torch.Tensor, x: torch.Tensor, *, t: int,
            chunk_words: int = CHUNK_WORDS) -> torch.Tensor:
    """Count mxv: ``int32[R * t]``, ``Σ popcount(tile_r & x[col])``."""
    tr = _tile_rows(tile_row_ptr)
    out = torch.zeros((tile_row_ptr.shape[0] - 1, t), dtype=torch.int32,
                      device=x.device)
    step = max(1, chunk_words // (t * t))
    for s in range(0, tile_col_idx.shape[0], step):
        xw = x[tile_col_idx[s:s + step].long()]
        out.index_add_(0, tr[s:s + step],
                       popcount(bit_tiles[s:s + step] & xw.unsqueeze(-1)))
    return out.reshape(-1)
