"""GraphBLAS operations over B2SR: the torch word-level schemes (``b2sr``).

The torch twin of ``repro.core.ops`` for the Table II mxv rows:

  bmv_bin_bin_bin     A:1-bit, x:1-bit, y:1-bit   (boolean semiring: BFS)
  bmv_bin_bin_full    A:1-bit, x:1-bit, y:counts  (neighbour counts)
  bmv_bin_full_full   A:1-bit, x:full,  y:full    (any semiring: SSSP, CC,
                                                   PageRank)

Each scheme's per-slab math lives in a ``_*_block`` helper taking raw
``(col_idx, tiles)`` ELL arrays, so the single-ELL path (mapped over row
chunks) and the bucketed path (one call per bucket slab, scattered back
through the row permutation) run the same computation.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.b2sr import B2SRBucketedEll, B2SREll, ceil_div
from repro_torch.core.dispatch import apply_output_mask, register
from repro_torch.core.semiring import ARITHMETIC, BOOLEAN, Semiring
from repro_torch.core.words import WORD, pack_bits, popcount, unpack_bits


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


def _bmv_bbf_block(col_idx: torch.Tensor, tiles: torch.Tensor,
                   x_packed: torch.Tensor, out_dtype) -> torch.Tensor:
    """bin·bin→full on one ELL slab: counts [R, t]."""
    xw = _gather_words(x_packed, col_idx)               # [R, K]
    counts = popcount(tiles & xw.unsqueeze(-1))         # [R, K, t]
    return counts.sum(dim=1).to(out_dtype)              # [R, t]


def bmv_bin_bin_full(ell: B2SREll, x_packed: torch.Tensor,
                     out_dtype=torch.float32,
                     row_chunk: Optional[int] = None) -> torch.Tensor:
    """Count mxv: y[i*t+r] = Σ popcount(word_r & x_word)."""
    out = _mapped_over_rows(
        lambda c, tl: _bmv_bbf_block(c, tl, x_packed, out_dtype),
        (ell.tile_col_idx, ell.bit_tiles), ell.n_tile_rows, row_chunk)
    return out.reshape(-1)[: ell.n_rows]


def bmv_bin_bin_full_bucketed(b: B2SRBucketedEll, x_packed: torch.Tensor,
                              out_dtype=torch.float32) -> torch.Tensor:
    """Bucketed count mxv: empty tile-rows keep the 0 count (Σ-identity)."""
    out = torch.zeros((b.n_tile_rows, b.tile_dim), dtype=out_dtype,
                      device=x_packed.device)
    for col, tiles, rows in zip(b.col_idx, b.bit_tiles, b.rows):
        out[rows.long()] = _bmv_bbf_block(col, tiles, x_packed, out_dtype)
    return out.reshape(-1)[: b.n_rows]


def bmv_bin_bin_full_masked(ell: B2SREll, x_packed: torch.Tensor,
                            mask: torch.Tensor, complement: bool = False,
                            out_dtype=torch.float32,
                            row_chunk: Optional[int] = None) -> torch.Tensor:
    """Masked count mxv (§V mask-at-store)."""
    y = bmv_bin_bin_full(ell, x_packed, out_dtype, row_chunk)
    return apply_output_mask(y, mask, complement,
                             torch.zeros((), dtype=out_dtype))


def _reduce(semiring: Semiring, arr: torch.Tensor, dim: int) -> torch.Tensor:
    """⊕-reduction along ``dim`` (``sum``, ``amin`` or ``amax``; ``any``
    for the boolean semiring)."""
    if semiring is BOOLEAN:
        return arr.any(dim=dim)
    return getattr(arr, semiring.reduce)(dim=dim)


def bff_setup(n_cols: int, t: int, x: torch.Tensor, semiring: Semiring,
               a_value: float):
    """Shared bin·full→full operand prep: padded x tiles, identity, a_value.

    The boolean semiring takes a bool ``x`` and the others a floating one:
    the reference's scan carry keeps ``x``'s dtype, so any other pairing
    fails there too.
    """
    if (x.dtype == torch.bool) != (semiring is BOOLEAN) or not (
            x.dtype == torch.bool or x.dtype.is_floating_point):
        raise TypeError(f"the {semiring.name} semiring's dense mxv takes "
                        f"{'a bool' if semiring is BOOLEAN else 'a floating'}"
                        f" x, got {x.dtype}")
    n_tc = ceil_div(n_cols, t)
    ident = semiring.identity_for(x.dtype, x.device)
    x_pad = torch.cat([x, ident.expand(n_tc * t - x.shape[0])])
    av = torch.tensor(a_value, dtype=x.dtype, device=x.device)
    return x_pad.view(n_tc, t), ident, av


def _bmv_bff_block(col_idx: torch.Tensor, tiles: torch.Tensor,
                   x3: torch.Tensor, semiring: Semiring, av: torch.Tensor,
                   ident: torch.Tensor, t: int) -> torch.Tensor:
    """bin·full→full on one ELL slab: ⊕-accumulated values [R, t].

    Walks the K axis in order, as the reference's scan does, so the sum
    mode adds the per-tile partials in the reference's order.
    """
    n_tc = x3.shape[0]
    acc = ident.expand(col_idx.shape[0], t).clone()
    for k in range(col_idx.shape[1]):
        cols = col_idx[:, k]                                # [R]
        bits = unpack_bits(tiles[:, k], t)                  # [R, t(row), t(col)]
        xk = x3[cols.clamp(0, n_tc - 1).long()]             # [R, t]
        xk = torch.where((cols >= 0).unsqueeze(-1), xk, ident)
        contrib = torch.where(bits, semiring.mul(av, xk.unsqueeze(1)), ident)
        acc = semiring.add(acc, _reduce(semiring, contrib, dim=2))
    return acc


def bmv_bin_full_full(ell: B2SREll, x: torch.Tensor,
                      semiring: Semiring = ARITHMETIC, a_value: float = 1.0,
                      row_chunk: Optional[int] = None) -> torch.Tensor:
    """General-semiring mxv: y_i = ⊕_j (A_ij ? a_value ⊗ x_j : ⊕-identity).

    The select form: an absent edge contributes the identity whatever
    ``x_j`` holds, so an ``inf`` in ``x`` cannot leak through it.
    """
    t = ell.tile_dim
    x3, ident, av = bff_setup(ell.n_cols, t, x, semiring, a_value)
    out = _mapped_over_rows(
        lambda c, tl: _bmv_bff_block(c, tl, x3, semiring, av, ident, t),
        (ell.tile_col_idx, ell.bit_tiles), ell.n_tile_rows, row_chunk)
    return out.reshape(-1)[: ell.n_rows]


def bmv_bin_full_full_bucketed(b: B2SRBucketedEll, x: torch.Tensor,
                               semiring: Semiring = ARITHMETIC,
                               a_value: float = 1.0) -> torch.Tensor:
    """Bucketed general-semiring mxv: empty tile-rows keep the ⊕-identity."""
    t = b.tile_dim
    x3, ident, av = bff_setup(b.n_cols, t, x, semiring, a_value)
    out = ident.expand(b.n_tile_rows, t).clone()
    for col, tiles, rows in zip(b.col_idx, b.bit_tiles, b.rows):
        out[rows.long()] = _bmv_bff_block(col, tiles, x3, semiring, av,
                                          ident, t)
    return out.reshape(-1)[: b.n_rows]


def bmv_bin_full_full_masked(ell: B2SREll, x: torch.Tensor,
                             mask: torch.Tensor,
                             semiring: Semiring = ARITHMETIC,
                             a_value: float = 1.0, complement: bool = False,
                             row_chunk: Optional[int] = None) -> torch.Tensor:
    """Masked general-semiring mxv (§V mask-at-store)."""
    y = bmv_bin_full_full(ell, x, semiring, a_value, row_chunk)
    return apply_output_mask(y, mask, complement,
                             semiring.identity_for(y.dtype))


def vxm(ell_t: B2SREll, x: torch.Tensor, **kw) -> torch.Tensor:
    """vᵀ·A == Aᵀ·v: callers pass the transposed B2SR's ELL view."""
    return bmv_bin_full_full(ell_t, x, **kw)


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


@register("mxv", "dense", "full", "b2sr", bucketed=False, masked=False)
def _mxv_dense(g, x, call):
    return bmv_bin_full_full(g.ell, x, call.semiring, call.a_value,
                             call.row_chunk)


@register("mxv", "dense", "full", "b2sr", bucketed=False, masked=True)
def _mxv_dense_masked(g, x, call):
    return bmv_bin_full_full_masked(g.ell, x, call.mask, call.semiring,
                                    call.a_value, call.complement,
                                    call.row_chunk)


@register("mxv", "dense", "full", "b2sr", bucketed=True, masked=False)
def _mxv_dense_bucketed(g, x, call):
    return bmv_bin_full_full_bucketed(g.buckets(), x, call.semiring,
                                      call.a_value)


@register("mxv", "dense", "full", "b2sr", bucketed=True, masked=True)
def _mxv_dense_bucketed_masked(g, x, call):
    y = bmv_bin_full_full_bucketed(g.buckets(), x, call.semiring,
                                   call.a_value)
    return apply_output_mask(y, call.mask, call.complement,
                             call.semiring.identity_for(y.dtype))


@register("mxv", "bitvec", "full", "b2sr", bucketed=False, masked=False)
def _mxv_count(g, xw, call):
    return bmv_bin_bin_full(g.ell, xw, call.out_dtype, call.row_chunk)


@register("mxv", "bitvec", "full", "b2sr", bucketed=False, masked=True)
def _mxv_count_masked(g, xw, call):
    return bmv_bin_bin_full_masked(g.ell, xw, call.mask, call.complement,
                                   call.out_dtype, call.row_chunk)


@register("mxv", "bitvec", "full", "b2sr", bucketed=True, masked=False)
def _mxv_count_bucketed(g, xw, call):
    return bmv_bin_bin_full_bucketed(g.buckets(), xw, call.out_dtype)


@register("mxv", "bitvec", "full", "b2sr", bucketed=True, masked=True)
def _mxv_count_bucketed_masked(g, xw, call):
    y = bmv_bin_bin_full_bucketed(g.buckets(), xw, call.out_dtype)
    return apply_output_mask(y, call.mask, call.complement,
                             torch.zeros((), dtype=call.out_dtype))
