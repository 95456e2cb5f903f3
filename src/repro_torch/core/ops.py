"""GraphBLAS operations over B2SR: the torch word-level schemes (``b2sr``).

The torch twin of ``repro.core.ops`` for the Table II mxv rows and the
Table III mxm rows over graph operands:

  bmv_bin_bin_bin     A:1-bit, x:1-bit, y:1-bit   (boolean semiring: BFS)
  bmv_bin_bin_full    A:1-bit, x:1-bit, y:counts  (neighbour counts)
  bmv_bin_full_full   A:1-bit, x:full,  y:full    (any semiring: SSSP, CC,
                                                   PageRank)
  spmm_b2sr           A:1-bit, X:full,  Y:full    (dense SpMM: batched PPR)
  spmm_bin_bin_bin    A:1-bit, F:1-bit, Y:1-bit   (S packed frontiers:
                                                   the multi-source engine)
  spmm_bin_bin_full   A:1-bit, X:1-bit, Y:counts  (packed activations:
                                                   the BitGNN layer)
  mxm_bin_bin_bin     A:1-bit, B:1-bit, C:1-bit   (boolean SpGEMM, k-hop)
  mxm_bin_bin_full    A:1-bit, B:1-bit, C:counts  (common neighbours)
  bmm_bin_bin_sum_masked   Σ mask ⊙ (A·B)         (triangle counting)

The mxm schemes build what the reference's do: ELL walks into a dense
packed grid ``[R, C, t]`` or a dense ``[n_rows, n_cols]`` count matrix
(``n_rows * n_cols`` bytes and more), and the SpMM schemes
``[R, t, t, W]`` and ``[R, t, t]`` intermediates per ELL slot, so they
run at small sizes only; the ``b2sr_cuda`` kernels and the ``csr`` rows
keep products sparse.
Sums are int64 here, where the reference's are float32 or int32.

Each scheme's per-slab math lives in a ``_*_block`` helper taking raw
``(col_idx, tiles)`` ELL arrays, so the single-ELL path (mapped over row
chunks) and the bucketed path (one call per bucket slab, scattered back
through the row permutation) run the same computation.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.b2sr import (B2SRBucketedEll, B2SREll,
                                   bit_transpose_words, ceil_div,
                                   ell_to_packed_grid, or_reduce_words,
                                   packed_grid_to_b2sr, unpack_tiles)
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
# SpMM: B2SR × dense matrix (the batched PPR product)
# ---------------------------------------------------------------------------

def _dense_tiles(x: torch.Tensor, n_cols: int, t: int) -> torch.Tensor:
    """Dense ``[n_cols, d]`` -> zero-padded column tiles ``[n_tc, t, d]``."""
    n_tc = ceil_div(n_cols, t)
    x_pad = torch.nn.functional.pad(x, (0, 0, 0, n_tc * t - x.shape[0]))
    return x_pad.view(n_tc, t, x.shape[1])


def _spmm_block(col_idx: torch.Tensor, tiles: torch.Tensor, x3: torch.Tensor,
                t: int, out_dtype) -> torch.Tensor:
    """SpMM on one ELL slab: accumulated feature tiles ``[R, t, d]``.

    Walks the K axis in order, as the reference's scan does: each step a
    batched ``t x t`` 0/1 tile times the gathered ``t x d`` panel.
    """
    n_tc = x3.shape[0]
    acc = torch.zeros((col_idx.shape[0], t, x3.shape[2]), dtype=out_dtype,
                      device=x3.device)
    for k in range(col_idx.shape[1]):
        cols = col_idx[:, k]
        bits = unpack_tiles(tiles[:, k], t, x3.dtype)          # [R, t, t]
        xk = x3[cols.clamp(0, n_tc - 1).long()]                # [R, t, d]
        xk = torch.where((cols >= 0)[:, None, None], xk, 0)
        acc = acc + torch.bmm(bits, xk).to(out_dtype)
    return acc


def spmm_b2sr(ell: B2SREll, x: torch.Tensor, out_dtype=None,
              row_chunk: Optional[int] = None) -> torch.Tensor:
    """Y = A @ X with binary A and dense X ``[n_cols, d]``: ``[n_rows, d]``.

    The Table II bin·full→full scheme widened to a dense right-hand
    matrix; the sum runs in ``x``'s dtype unless ``out_dtype`` says.
    """
    t = ell.tile_dim
    out_dtype = out_dtype or x.dtype
    x3 = _dense_tiles(x, ell.n_cols, t)
    out = _mapped_over_rows(
        lambda c, tl: _spmm_block(c, tl, x3, t, out_dtype),
        (ell.tile_col_idx, ell.bit_tiles), ell.n_tile_rows, row_chunk)
    return out.reshape(-1, x.shape[1])[: ell.n_rows]


def spmm_b2sr_bucketed(b: B2SRBucketedEll, x: torch.Tensor,
                       out_dtype=None) -> torch.Tensor:
    """Bucketed SpMM: empty tile-rows keep the zero rows."""
    t = b.tile_dim
    out_dtype = out_dtype or x.dtype
    x3 = _dense_tiles(x, b.n_cols, t)
    out = torch.zeros((b.n_tile_rows, t, x.shape[1]), dtype=out_dtype,
                      device=x.device)
    for col, tiles, rows in zip(b.col_idx, b.bit_tiles, b.rows):
        out[rows.long()] = _spmm_block(col, tiles, x3, t, out_dtype)
    return out.reshape(-1, x.shape[1])[: b.n_rows]


# ---------------------------------------------------------------------------
# SpMM over packed activation matrices: bin·bin→full (the BitGNN layer)
# ---------------------------------------------------------------------------

def _spmm_bbf_block(col_idx: torch.Tensor, tiles: torch.Tensor,
                    xw: torch.Tensor, out_dtype) -> torch.Tensor:
    """bin·bin→full on one ELL slab against ``BitMatrix`` words.

    ``xw`` is ``int32[n_tile_cols, d]``; per output element
    ``y[i*t+r, j] = Σ_k popcount(tile_word_r(i, k) & xw[col(i, k), j])``,
    the feature-wide ``_bmv_bbf_block``, walked over K as the reference's
    scan does. Returns counts ``[R, t, d]``.
    """
    acc = torch.zeros((col_idx.shape[0], tiles.shape[2], xw.shape[1]),
                      dtype=torch.int64, device=xw.device)
    for k in range(col_idx.shape[1]):
        cols = col_idx[:, k]                                   # [R]
        xk = torch.where((cols >= 0)[:, None],
                         xw[cols.clamp(0, xw.shape[0] - 1).long()], 0)
        acc += popcount(tiles[:, k, :, None] & xk[:, None, :])  # [R, t, d]
    return acc.to(out_dtype)


def spmm_bin_bin_full(ell: B2SREll, xw: torch.Tensor, out_dtype=torch.float32,
                      row_chunk: Optional[int] = None) -> torch.Tensor:
    """BitGNN aggregation: packed adjacency × ``BitMatrix`` words →
    popcount counts ``[n_rows, d]`` in ``out_dtype``; the α and sign
    reconstruction is the caller's (``repro_torch.gnn_bit``)."""
    out = _mapped_over_rows(
        lambda c, tl: _spmm_bbf_block(c, tl, xw, out_dtype),
        (ell.tile_col_idx, ell.bit_tiles), ell.n_tile_rows, row_chunk)
    return out.reshape(-1, xw.shape[1])[: ell.n_rows]


def spmm_bin_bin_full_bucketed(b: B2SRBucketedEll, xw: torch.Tensor,
                               out_dtype=torch.float32) -> torch.Tensor:
    """Bucketed BitGNN aggregation: empty tile-rows keep the 0 count."""
    out = torch.zeros((b.n_tile_rows, b.tile_dim, xw.shape[1]),
                      dtype=out_dtype, device=xw.device)
    for col, tiles, rows in zip(b.col_idx, b.bit_tiles, b.rows):
        out[rows.long()] = _spmm_bbf_block(col, tiles, xw, out_dtype)
    return out.reshape(-1, xw.shape[1])[: b.n_rows]


# ---------------------------------------------------------------------------
# SpMM over packed frontier matrices: bin·bin→bin with a wide right side
# ---------------------------------------------------------------------------

def _spmm_bbb_block(col_idx: torch.Tensor, tiles: torch.Tensor,
                    f3: torch.Tensor, t: int) -> torch.Tensor:
    """bin·bin→bin on one ELL slab against a packed frontier matrix.

    ``f3`` is ``int32[n_tile_cols, t, W]``; output word ``[i, r, w] =
    OR_c (A_tile[r, c] ? f3[col, c, w] : 0)``: the AND/shift word scheme
    with a packed right side, so A's tiles are read once for all S
    sources. Returns ``int32[R, t, W]``.
    """
    n_tc = f3.shape[0]
    acc = torch.zeros((col_idx.shape[0], t, f3.shape[2]), dtype=WORD,
                      device=f3.device)
    for k in range(col_idx.shape[1]):
        cols = col_idx[:, k]                                   # [R]
        a_bits = unpack_bits(tiles[:, k], t)                   # [R, t(r), t(c)]
        fk = f3[cols.clamp(0, n_tc - 1).long()]                # [R, t(c), W]
        fk = torch.where((cols >= 0)[:, None, None], fk, 0)
        contrib = torch.where(a_bits[..., None], fk[:, None], 0)  # [R,t,t,W]
        acc = acc | or_reduce_words(contrib, (2,))
    return acc


def spmm_bin_bin_bin(ell: B2SREll, f_packed: torch.Tensor,
                     row_chunk: Optional[int] = None) -> torch.Tensor:
    """Multi-frontier boolean traversal: ``[n_tile_cols, t, W]`` packed
    frontiers in, ``[n_tile_rows, t, W]`` out. Column ``s`` equals
    ``bmv_bin_bin_bin`` on frontier ``s`` bit for bit."""
    return _mapped_over_rows(
        lambda c, tl: _spmm_bbb_block(c, tl, f_packed, ell.tile_dim),
        (ell.tile_col_idx, ell.bit_tiles), ell.n_tile_rows, row_chunk)


def apply_frontier_mask(y: torch.Tensor, mask_packed: torch.Tensor,
                        complement: bool) -> torch.Tensor:
    """AND a packed per-source visited mask into a frontier matrix (§V);
    shared by every multi-frontier path."""
    return y & (~mask_packed if complement else mask_packed)


def spmm_bin_bin_bin_masked(ell: B2SREll, f_packed: torch.Tensor,
                            mask_packed: torch.Tensor, complement: bool = True,
                            row_chunk: Optional[int] = None) -> torch.Tensor:
    """Masked multi-frontier traversal: the msBFS step. ``mask_packed`` has
    the output layout; ``complement=True`` keeps the unvisited bits."""
    return apply_frontier_mask(spmm_bin_bin_bin(ell, f_packed, row_chunk),
                               mask_packed, complement)


def spmm_bin_bin_bin_bucketed(b: B2SRBucketedEll,
                              f_packed: torch.Tensor) -> torch.Tensor:
    """Bucketed multi-frontier traversal; empty tile-rows keep zero words."""
    out = torch.zeros((b.n_tile_rows, b.tile_dim, f_packed.shape[2]),
                      dtype=WORD, device=f_packed.device)
    for col, tiles, rows in zip(b.col_idx, b.bit_tiles, b.rows):
        out[rows.long()] = _spmm_bbb_block(col, tiles, f_packed, b.tile_dim)
    return out


def spmm_bin_bin_bin_bucketed_masked(b: B2SRBucketedEll,
                                     f_packed: torch.Tensor,
                                     mask_packed: torch.Tensor,
                                     complement: bool = True) -> torch.Tensor:
    """Masked bucketed multi-frontier traversal (mask ANDed after the merge)."""
    return apply_frontier_mask(spmm_bin_bin_bin_bucketed(b, f_packed),
                               mask_packed, complement)


def spmm_bin_bin_bin_pull(ell: B2SREll, f_packed: torch.Tensor,
                          mask_packed: torch.Tensor, complement: bool = True,
                          row_chunk: Optional[int] = None) -> torch.Tensor:
    """Pull-direction multi-frontier traversal: the masked push math, as
    for :func:`bmv_bin_bin_bin_pull` (bit-exact by construction)."""
    return spmm_bin_bin_bin_masked(ell, f_packed, mask_packed, complement,
                                   row_chunk)


def spmm_bin_bin_bin_pull_bucketed(b: B2SRBucketedEll, f_packed: torch.Tensor,
                                   mask_packed: torch.Tensor,
                                   complement: bool = True) -> torch.Tensor:
    return spmm_bin_bin_bin_bucketed_masked(b, f_packed, mask_packed,
                                            complement)


# ---------------------------------------------------------------------------
# BMM: bin × bin -> masked scalar sum (the TC reduction, paper Listing 2)
# ---------------------------------------------------------------------------

def _tile_products(a_words: torch.Tensor, bt_words: torch.Tensor) -> torch.Tensor:
    """Count tiles of A·B from A's words and Bᵀ's words (B's bit-columns):
    ``P[..., r, c] = popcount(a[r] & bᵀ[c])`` (int32 ``[..., t, t]``)."""
    return popcount(a_words.unsqueeze(-1) & bt_words.unsqueeze(-2))


def bmm_bin_bin_sum_masked(a: B2SREll, b: B2SREll, mask: B2SREll,
                           row_chunk: Optional[int] = None) -> torch.Tensor:
    """Fused masked BMM: Σ mask ⊙ (A·B) as an int64 scalar.

    For TC: A = mask = L, B = Lᵀ. The reference's walk: for every A tile
    (i, m), B's tile-row m; each B tile (m, j) adds to C tile (i, j),
    whose mask tile is found by matching j against mask row i.
    """
    t = a.tile_dim

    def chunk(a_col, a_tiles, m_col, m_tiles):
        total = torch.zeros((), dtype=torch.int64, device=a_col.device)
        for ka in range(a_col.shape[1]):
            ac = a_col[:, ka]
            safe = ac.clamp(0, b.n_tile_rows - 1).long()
            b_cols = b.tile_col_idx[safe]                        # [R, Kb]
            b_t = bit_transpose_words(b.bit_tiles[safe], t)      # [R, Kb, t]
            for kb in range(b_cols.shape[1]):
                bc = b_cols[:, kb]
                prod = _tile_products(a_tiles[:, ka], b_t[:, kb])  # [R, t, t]
                match = (m_col == bc[:, None]) & (m_col >= 0)     # [R, Km]
                m_words = or_reduce_words(
                    torch.where(match[..., None], m_tiles, 0), (1,))
                m_bits = unpack_bits(m_words, t)                  # [R, t, t]
                ok = (ac >= 0) & (bc >= 0)
                total += torch.where(ok[:, None, None] & m_bits, prod,
                                     0).sum(dtype=torch.int64)
        return total

    arrays = (a.tile_col_idx, a.bit_tiles, mask.tile_col_idx, mask.bit_tiles)
    return _summed_over_rows(chunk, arrays, a.n_tile_rows, row_chunk)


def bmm_bin_bin_sum(a: B2SREll, b: B2SREll,
                    row_chunk: Optional[int] = None) -> torch.Tensor:
    """Unmasked Σ (A·B) = Σ_r Σ_m A[r, m] · (row m's popcount in B)."""
    t = a.tile_dim

    def chunk(a_col, a_tiles):
        total = torch.zeros((), dtype=torch.int64, device=a_col.device)
        for ka in range(a_col.shape[1]):
            ac = a_col[:, ka]
            safe = ac.clamp(0, b.n_tile_rows - 1).long()
            b_valid = b.tile_col_idx[safe] >= 0                  # [R, Kb]
            b_row_pop = torch.where(b_valid[..., None],
                                    popcount(b.bit_tiles[safe]),
                                    0).sum(1, dtype=torch.int64)  # [R, t(m)]
            a_bits = unpack_bits(a_tiles[:, ka], t)              # [R, t, t]
            contrib = torch.where(a_bits, b_row_pop[:, None, :], 0)
            total += torch.where((ac >= 0)[:, None, None], contrib,
                                 0).sum(dtype=torch.int64)
        return total

    return _summed_over_rows(chunk, (a.tile_col_idx, a.bit_tiles),
                             a.n_tile_rows, row_chunk)


def _summed_over_rows(fn, arrays, n_rows: int, row_chunk: Optional[int]):
    """``fn`` over row chunks of the leading axis, summed."""
    if row_chunk is None or row_chunk >= n_rows:
        return fn(*arrays)
    if n_rows % row_chunk != 0:
        raise ValueError(f"row_chunk {row_chunk} must divide n_rows {n_rows} "
                         f"(pad the ELL view)")
    return sum(fn(*(a[s:s + row_chunk] for a in arrays))
               for s in range(0, n_rows, row_chunk))


# ---------------------------------------------------------------------------
# MXM: bin × bin -> bin / full SpGEMM (paper Table III)
# ---------------------------------------------------------------------------

def _check_mxm_dims(a, b) -> None:
    if a.tile_dim != b.tile_dim:
        raise ValueError(f"tile_dim mismatch: {a.tile_dim} vs {b.tile_dim}")
    if a.n_cols != b.n_rows:
        raise ValueError(f"inner-dim mismatch: A is {a.n_rows}x{a.n_cols}, "
                         f"B is {b.n_rows}x{b.n_cols}")


def mxm_bin_bin_bin(a: B2SREll, b: B2SREll, mask: Optional[B2SREll] = None,
                    complement: bool = False,
                    row_chunk: Optional[int] = None) -> torch.Tensor:
    """Boolean SpGEMM C⟨M⟩ = A ∨.∧ B: the packed grid ``[R, n_tc(B), t]``.

    The AND/shift word algorithm: C's bit-row r ORs in B's word-row k for
    every set bit k of A's word-row r. Compress with
    ``packed_grid_to_b2sr``; the mask is ANDed before the return.
    """
    _check_mxm_dims(a, b)
    out = _mapped_over_rows(
        lambda c, tl: _mxm_bbb_block(c, tl, b, a.tile_dim),
        (a.tile_col_idx, a.bit_tiles), a.n_tile_rows, row_chunk)
    return apply_grid_mask(out, mask, complement)


def apply_grid_mask(grid: torch.Tensor, mask: Optional[B2SREll],
                    complement: bool) -> torch.Tensor:
    """AND a structural mask (or its complement) into a packed grid."""
    if mask is None:
        return grid
    mg = ell_to_packed_grid(mask)
    return grid & (~mg if complement else mg)


def _b_rows(b: B2SREll, ac: torch.Tensor):
    """B's ELL tile-rows selected by A's tile columns ``ac`` (-1 = pad)."""
    safe = ac.clamp(0, b.tile_col_idx.shape[0] - 1).long()
    b_cols = b.tile_col_idx[safe]                            # [R, Kb]
    ok = (ac >= 0)[:, None] & (b_cols >= 0)
    return b_cols, b.bit_tiles[safe], ok


def _mxm_bbb_block(a_col: torch.Tensor, a_tiles: torch.Tensor, b: B2SREll,
                   t: int) -> torch.Tensor:
    """Boolean SpGEMM for one A-side ELL slab: packed grid [R, n_tc_b, t]."""
    n_tc_b = ceil_div(b.n_cols, t)
    acc = torch.zeros((a_col.shape[0], n_tc_b, t), dtype=WORD,
                      device=a_col.device)
    for k in range(a_col.shape[1]):
        b_cols, b_tls, ok = _b_rows(b, a_col[:, k])
        a_bits = unpack_bits(a_tiles[:, k], t)               # [R, t(r), t(k)]
        # AND/shift: broadcast B's word k where A bit (r, k) is set
        contrib = torch.where(a_bits[:, None], b_tls[:, :, None, :], 0)
        c_words = or_reduce_words(contrib, (3,))             # [R, Kb, t(r)]
        r, kb = torch.nonzero(ok, as_tuple=True)
        cols = b_cols[r, kb].long()
        # distinct tile columns per row and step: assignment is the merge
        acc[r, cols] = acc[r, cols] | c_words[r, kb]
    return acc


def mxm_bin_bin_bin_bucketed(a: B2SRBucketedEll, b: B2SREll,
                             mask: Optional[B2SREll] = None,
                             complement: bool = False) -> torch.Tensor:
    """Bucketed boolean SpGEMM: A's tile-rows per bucket, B one ELL."""
    _check_mxm_dims(a, b)
    t = a.tile_dim
    out = torch.zeros((a.n_tile_rows, ceil_div(b.n_cols, t), t), dtype=WORD,
                      device=b.tile_col_idx.device)
    for col, tiles, rows in zip(a.col_idx, a.bit_tiles, a.rows):
        out[rows.long()] = _mxm_bbb_block(col, tiles, b, t)
    return apply_grid_mask(out, mask, complement)


def _mxm_bbf_block(a_col: torch.Tensor, a_tiles: torch.Tensor, b: B2SREll,
                   t: int) -> torch.Tensor:
    """Count SpGEMM for one A-side ELL slab: count tiles [R, n_tc_b, t, t]."""
    n_tc_b = ceil_div(b.n_cols, t)
    acc = torch.zeros((a_col.shape[0], n_tc_b, t, t), dtype=torch.int32,
                      device=a_col.device)
    for k in range(a_col.shape[1]):
        b_cols, b_tls, ok = _b_rows(b, a_col[:, k])
        prod = _tile_products(a_tiles[:, k, None, :],
                              bit_transpose_words(b_tls, t))  # [R, Kb, t, t]
        r, kb = torch.nonzero(ok, as_tuple=True)
        cols = b_cols[r, kb].long()
        acc[r, cols] += prod[r, kb]
    return acc


def _count_grid_to_dense(grid: torch.Tensor, n_rows: int, n_cols: int,
                         out_dtype) -> torch.Tensor:
    r_n, c_n, t, _ = grid.shape
    dense = grid.permute(0, 2, 1, 3).reshape(r_n * t, c_n * t)
    return dense[:n_rows, :n_cols].to(out_dtype)


def mxm_bin_bin_full(a: B2SREll, b: B2SREll, out_dtype=torch.int32,
                     row_chunk: Optional[int] = None) -> torch.Tensor:
    """Count SpGEMM C = A +.× B: the dense ``[n_rows, n_cols]`` counts."""
    _check_mxm_dims(a, b)
    grid = _mapped_over_rows(
        lambda c, tl: _mxm_bbf_block(c, tl, b, a.tile_dim),
        (a.tile_col_idx, a.bit_tiles), a.n_tile_rows, row_chunk)
    return _count_grid_to_dense(grid, a.n_rows, b.n_cols, out_dtype)


def mxm_bin_bin_full_bucketed(a: B2SRBucketedEll, b: B2SREll,
                              out_dtype=torch.int32) -> torch.Tensor:
    """Bucketed count SpGEMM: dense ``[n_rows, n_cols]`` counts."""
    _check_mxm_dims(a, b)
    t = a.tile_dim
    grid = torch.zeros((a.n_tile_rows, ceil_div(b.n_cols, t), t, t),
                       dtype=torch.int32, device=b.tile_col_idx.device)
    for col, tiles, rows in zip(a.col_idx, a.bit_tiles, a.rows):
        grid[rows.long()] = _mxm_bbf_block(col, tiles, b, t)
    return _count_grid_to_dense(grid, a.n_rows, b.n_cols, out_dtype)


def _apply_dense_mask(counts: torch.Tensor, mask: B2SREll,
                      complement: bool) -> torch.Tensor:
    t = mask.tile_dim
    mg = unpack_bits(ell_to_packed_grid(mask), t)            # [R, C, t, t]
    m_dense = mg.permute(0, 2, 1, 3).reshape(
        mg.shape[0] * t, mg.shape[1] * t)[: mask.n_rows, : mask.n_cols]
    keep = ~m_dense if complement else m_dense
    return torch.where(keep, counts, 0)


def mxm_bin_bin_full_masked(a: B2SREll, b: B2SREll, mask: B2SREll,
                            complement: bool = False, out_dtype=torch.int32,
                            row_chunk: Optional[int] = None) -> torch.Tensor:
    """Masked count SpGEMM C⟨M⟩ = A +.× B with a structural B2SR mask;
    ``sum(mxm_bin_bin_full_masked(L, Lᵀ, L))`` is the triangle count."""
    counts = mxm_bin_bin_full(a, b, out_dtype, row_chunk)
    return _apply_dense_mask(counts, mask, complement)


def mxm_bin_bin_full_masked_bucketed(a: B2SRBucketedEll, b: B2SREll,
                                     mask: B2SREll, complement: bool = False,
                                     out_dtype=torch.int32) -> torch.Tensor:
    """Bucketed masked count SpGEMM."""
    counts = mxm_bin_bin_full_bucketed(a, b, out_dtype)
    return _apply_dense_mask(counts, mask, complement)


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


# -- mxm over dense and frontier operands: the widened Table II rows ---------

@register("mxm", "dense", "full", "b2sr", bucketed=False, masked=False)
def _mxm_dense(g, x, call):
    return spmm_b2sr(g.ell, x, row_chunk=call.row_chunk)


@register("mxm", "dense", "full", "b2sr", bucketed=False, masked=True)
def _mxm_dense_masked(g, x, call):
    y = spmm_b2sr(g.ell, x, row_chunk=call.row_chunk)
    return apply_output_mask(y, call.mask, call.complement,
                             call.semiring.identity_for(y.dtype))


@register("mxm", "dense", "full", "b2sr", bucketed=True, masked=False)
def _mxm_dense_bucketed(g, x, call):
    return spmm_b2sr_bucketed(g.buckets(), x)


@register("mxm", "dense", "full", "b2sr", bucketed=True, masked=True)
def _mxm_dense_bucketed_masked(g, x, call):
    y = spmm_b2sr_bucketed(g.buckets(), x)
    return apply_output_mask(y, call.mask, call.complement,
                             call.semiring.identity_for(y.dtype))


@register("mxm", "bitmat", "full", "b2sr", bucketed=False, masked=False)
def _mxm_bitmat(g, xw, call):
    return spmm_bin_bin_full(g.ell, xw, call.out_dtype, call.row_chunk)


@register("mxm", "bitmat", "full", "b2sr", bucketed=False, masked=True)
def _mxm_bitmat_masked(g, xw, call):
    y = spmm_bin_bin_full(g.ell, xw, call.out_dtype, call.row_chunk)
    return apply_output_mask(y, call.mask, call.complement,
                             call.semiring.identity_for(y.dtype))


@register("mxm", "bitmat", "full", "b2sr", bucketed=True, masked=False)
def _mxm_bitmat_bucketed(g, xw, call):
    return spmm_bin_bin_full_bucketed(g.buckets(), xw, call.out_dtype)


@register("mxm", "bitmat", "full", "b2sr", bucketed=True, masked=True)
def _mxm_bitmat_bucketed_masked(g, xw, call):
    y = spmm_bin_bin_full_bucketed(g.buckets(), xw, call.out_dtype)
    return apply_output_mask(y, call.mask, call.complement,
                             call.semiring.identity_for(y.dtype))


@register("mxm", "frontier", "bin", "b2sr", bucketed=False, masked=False)
def _mxm_frontier(g, fw, call):
    return spmm_bin_bin_bin(g.ell, fw, call.row_chunk)


@register("mxm", "frontier", "bin", "b2sr", bucketed=False, masked=True)
def _mxm_frontier_masked(g, fw, call):
    return spmm_bin_bin_bin_masked(g.ell, fw, call.mask, call.complement,
                                   call.row_chunk)


@register("mxm", "frontier", "bin", "b2sr", bucketed=True, masked=False)
def _mxm_frontier_bucketed(g, fw, call):
    return spmm_bin_bin_bin_bucketed(g.buckets(), fw)


@register("mxm", "frontier", "bin", "b2sr", bucketed=True, masked=True)
def _mxm_frontier_bucketed_masked(g, fw, call):
    return spmm_bin_bin_bin_bucketed_masked(g.buckets(), fw, call.mask,
                                            call.complement)


@register("mxm_pull", "frontier", "bin", "b2sr", bucketed=False, masked=True)
def _mxm_pull(g, fw, call):
    return spmm_bin_bin_bin_pull(g.ell, fw, call.mask, call.complement,
                                 call.row_chunk)


@register("mxm_pull", "frontier", "bin", "b2sr", bucketed=True, masked=True)
def _mxm_pull_bucketed(g, fw, call):
    return spmm_bin_bin_bin_pull_bucketed(g.buckets(), fw, call.mask,
                                          call.complement)


# -- mxm over graph operands: Table III ---------------------------------------
# The boolean rows return the B2SR of the packed grid (its all-zero tiles
# dropped); the count rows the dense int32 counts, as the reference's do.

def _mask_ell(call):
    return call.mask.ell if call.mask is not None else None


@register("mxm", "graph", "bin", "b2sr", bucketed=False)
def _mxm_graph(g, other, call):
    grid = mxm_bin_bin_bin(g.ell, other.ell, _mask_ell(call),
                           call.complement, call.row_chunk)
    return packed_grid_to_b2sr(grid, g.n_rows, other.n_cols)


@register("mxm", "graph", "bin", "b2sr", bucketed=True)
def _mxm_graph_bucketed(g, other, call):
    grid = mxm_bin_bin_bin_bucketed(g.buckets(), other.ell, _mask_ell(call),
                                    call.complement)
    return packed_grid_to_b2sr(grid, g.n_rows, other.n_cols)


def mxm_count(g, other, call, bucketed: bool) -> torch.Tensor:
    """The count rows (bin·bin→full) of ``b2sr`` and ``b2sr_cuda``."""
    if bucketed:
        counts = mxm_bin_bin_full_bucketed(g.buckets(), other.ell)
    else:
        counts = mxm_bin_bin_full(g.ell, other.ell, row_chunk=call.row_chunk)
    if call.mask is None:
        return counts
    return _apply_dense_mask(counts, call.mask.ell, call.complement)


@register("mxm", "graph", "full", "b2sr", bucketed=False)
def _mxm_graph_count(g, other, call):
    return mxm_count(g, other, call, bucketed=False)


@register("mxm", "graph", "full", "b2sr", bucketed=True)
def _mxm_graph_count_bucketed(g, other, call):
    return mxm_count(g, other, call, bucketed=True)


# -- mxm_sum: Σ mask ⊙ (A·B), tri_count's fused reduction ----------------------

@register("mxm_sum", "tri", "full", "b2sr", bucketed=False, masked=True)
def _tri_sum(g, tri, call):
    counts = mxm_bin_bin_full_masked(tri.ell, tri.ell_t, tri.ell,
                                     row_chunk=call.row_chunk)
    return counts.sum(dtype=torch.int64)


@register("mxm_sum", "tri", "full", "b2sr", bucketed=True, masked=True)
def _tri_sum_bucketed(g, tri, call):
    counts = mxm_bin_bin_full_masked_bucketed(tri.buckets(), tri.ell_t,
                                              tri.ell)
    return counts.sum(dtype=torch.int64)
