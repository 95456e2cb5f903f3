"""GraphBLAS operations over B2SR: the torch word-level schemes (``b2sr``).

The torch twin of ``repro.core.ops`` for the slice's Table II row,
bin·bin→bin (boolean semiring, packed frontier in and out): the BFS step.
Each scheme's per-slab math lives in ``_bmv_bbb_block`` taking raw
``(col_idx, tiles)`` ELL arrays, so the single-ELL path (mapped over row
chunks) and the bucketed path (one call per bucket slab, scattered back
through the row permutation) run the same computation.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.b2sr import B2SRBucketedEll, B2SREll
from repro_torch.core.dispatch import pending, register
from repro_torch.core.words import WORD, pack_bits


def _gather_words(x_packed: torch.Tensor, col_idx: torch.Tensor) -> torch.Tensor:
    """Gather packed vector words by tile-col index; padding (-1) -> word 0."""
    safe = col_idx.clamp(0, x_packed.shape[0] - 1).long()
    return torch.where(col_idx >= 0, x_packed[safe], torch.zeros_like(col_idx))


def _mapped_over_rows(fn, arrays, n_rows: int, row_chunk: Optional[int]):
    """Apply ``fn`` to row-chunks of the leading axis and concatenate."""
    if row_chunk is None or row_chunk >= n_rows:
        return fn(*arrays)
    if n_rows % row_chunk != 0:
        raise ValueError(f"row_chunk {row_chunk} must divide n_rows {n_rows} "
                         f"(pad the ELL view)")
    return torch.cat([fn(*(a[s:s + row_chunk] for a in arrays))
                      for s in range(0, n_rows, row_chunk)])


def _bmv_bbb_block(col_idx: torch.Tensor, tiles: torch.Tensor,
                   x_packed: torch.Tensor) -> torch.Tensor:
    """bin·bin→bin on one ELL slab: packed words int32[R]."""
    xw = _gather_words(x_packed, col_idx)              # [R, K]
    hit = (tiles & xw.unsqueeze(-1)) != 0              # [R, K, t]
    return pack_bits(hit.any(dim=1))


def _mask_words(y: torch.Tensor, mask_packed: torch.Tensor,
                complement: bool) -> torch.Tensor:
    return y & (~mask_packed if complement else mask_packed)


def bmv_bin_bin_bin(ell: B2SREll, x_packed: torch.Tensor,
                    row_chunk: Optional[int] = None) -> torch.Tensor:
    """Boolean mxv: y_bit[i*t+r] = OR_j A[i*t+r, j] & x[j]."""
    return _mapped_over_rows(lambda c, tl: _bmv_bbb_block(c, tl, x_packed),
                             (ell.tile_col_idx, ell.bit_tiles),
                             ell.n_tile_rows, row_chunk)


def bmv_bin_bin_bin_masked(ell: B2SREll, x_packed: torch.Tensor,
                           mask_packed: torch.Tensor, complement: bool = True,
                           row_chunk: Optional[int] = None) -> torch.Tensor:
    """Masked boolean mxv (§V mask ANDed right before the store)."""
    return _mask_words(bmv_bin_bin_bin(ell, x_packed, row_chunk),
                       mask_packed, complement)


def bmv_bin_bin_bin_bucketed(b: B2SRBucketedEll,
                             x_packed: torch.Tensor) -> torch.Tensor:
    """Bucketed boolean mxv: per-bucket slabs, outputs scattered by row id.

    Empty tile-rows are in no bucket and keep the zero word (OR-identity).
    """
    out = torch.zeros(b.n_tile_rows, dtype=WORD, device=x_packed.device)
    for col, tiles, rows in zip(b.col_idx, b.bit_tiles, b.rows):
        out[rows.long()] = _bmv_bbb_block(col, tiles, x_packed)
    return out


def bmv_bin_bin_bin_bucketed_masked(b: B2SRBucketedEll, x_packed: torch.Tensor,
                                    mask_packed: torch.Tensor,
                                    complement: bool = True) -> torch.Tensor:
    return _mask_words(bmv_bin_bin_bin_bucketed(b, x_packed), mask_packed,
                       complement)


def bmv_bin_bin_bin_pull(ell: B2SREll, x_packed: torch.Tensor,
                         mask_packed: torch.Tensor, complement: bool = True,
                         row_chunk: Optional[int] = None) -> torch.Tensor:
    """Pull-direction boolean mxv: the word-scheme twin of the pull kernel.

    Torch has no data-dependent row exit over a whole slab, so this runs
    the masked push math — which is what makes the pull row bit-exact
    against push by construction (the kernel's early exit only skips
    tiles that could add bits already set).
    """
    return bmv_bin_bin_bin_masked(ell, x_packed, mask_packed, complement,
                                  row_chunk)


def bmv_bin_bin_bin_pull_bucketed(b: B2SRBucketedEll, x_packed: torch.Tensor,
                                  mask_packed: torch.Tensor,
                                  complement: bool = True) -> torch.Tensor:
    return bmv_bin_bin_bin_bucketed_masked(b, x_packed, mask_packed,
                                           complement)


# ---------------------------------------------------------------------------
# Dispatch-registry entries: the "b2sr" rows
# ---------------------------------------------------------------------------

@register("mxv", "bitvec", "bin", "b2sr", bucketed=False, masked=False)
def _mxv_bitvec(g, xw, call):
    return bmv_bin_bin_bin(g.ell, xw, call.row_chunk)


@register("mxv", "bitvec", "bin", "b2sr", bucketed=False, masked=True)
def _mxv_bitvec_masked(g, xw, call):
    return bmv_bin_bin_bin_masked(g.ell, xw, call.mask, call.complement,
                                  call.row_chunk)


@register("mxv", "bitvec", "bin", "b2sr", bucketed=True, masked=False)
def _mxv_bitvec_bucketed(g, xw, call):
    return bmv_bin_bin_bin_bucketed(g.buckets(), xw)


@register("mxv", "bitvec", "bin", "b2sr", bucketed=True, masked=True)
def _mxv_bitvec_bucketed_masked(g, xw, call):
    return bmv_bin_bin_bin_bucketed_masked(g.buckets(), xw, call.mask,
                                           call.complement)


@register("mxv_pull", "bitvec", "bin", "b2sr", bucketed=False, masked=True)
def _mxv_pull(g, xw, call):
    return bmv_bin_bin_bin_pull(g.ell, xw, call.mask, call.complement,
                                call.row_chunk)


@register("mxv_pull", "bitvec", "bin", "b2sr", bucketed=True, masked=True)
def _mxv_pull_bucketed(g, xw, call):
    return bmv_bin_bin_bin_pull_bucketed(g.buckets(), xw, call.mask,
                                         call.complement)


pending("mxv", "dense", "full", "b2sr",
        "bmv_bin_full_full, ROADMAP Queue 1 item 4")
pending("mxv", "bitvec", "full", "b2sr",
        "bmv_bin_bin_full, ROADMAP Queue 1 item 4")
