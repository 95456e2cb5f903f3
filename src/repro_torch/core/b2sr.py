"""B2SR: Bit-Block Compressed Sparse Row format (torch port of ``repro.core.b2sr``).

Two-level representation of a binary sparse matrix:
  - upper level: CSR over fixed-size square tiles (tile_row_ptr / tile_col_idx)
  - lower level: each non-empty tile is a dense bit matrix; bit-row ``r`` of a
    tile is packed LSB-first into one word (bit ``j`` of word ``r`` is
    element ``[r, j]`` of the tile).

Every array matches the reference bit for bit; words are int32 bit
patterns (``repro_torch.core.words``). The conversion runs with torch on
the target device: the reference's host loops and its ``[n_tiles, t, t]``
bit transpose do not scale to Graph500-size graphs, so ``transpose`` here
is ``coo_to_b2sr`` of the swapped COO (canonical, hence identical).

The ELL and bucketed views are kept for the ``b2sr`` word schemes; the
CUDA kernels walk the CSR-over-tiles arrays directly and never need them.
The same holds for the dense packed grids ``uint32[R, C, t]`` of the
SpGEMM helpers at the end (``ell_to_packed_grid``,
``packed_grid_to_b2sr``): they take ``n_rows * n_cols / 8`` bytes, so only
the ``b2sr`` rows build them, at small sizes. Masks and unions of sparse
results merge the tile lists instead (:func:`combine_tiles`).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from repro_torch.core.words import (WORD, pack_bits, popcount, to_int32,
                                   unpack_bits)
from repro_torch.device import DeviceLike, resolve_device

TILE_DIMS = (4, 8, 16, 32)


def ceil_div(a: int, b: int) -> int:
    return -(-a // b)


@dataclasses.dataclass(frozen=True)
class B2SR:
    """CSR-over-tiles with bit-packed tiles (words are int32 bit patterns)."""

    tile_row_ptr: torch.Tensor   # int32[n_tile_rows + 1]
    tile_col_idx: torch.Tensor   # int32[n_tiles]
    bit_tiles: torch.Tensor      # int32[n_tiles, tile_dim]; low tile_dim bits used
    tile_dim: int
    n_rows: int
    n_cols: int
    nnz: int

    @property
    def n_tile_rows(self) -> int:
        return ceil_div(self.n_rows, self.tile_dim)

    @property
    def n_tile_cols(self) -> int:
        return ceil_div(self.n_cols, self.tile_dim)

    @property
    def n_tiles(self) -> int:
        return int(self.tile_col_idx.shape[0])

    @property
    def device(self) -> torch.device:
        return self.tile_row_ptr.device


@dataclasses.dataclass(frozen=True)
class B2SREll:
    """Padded (ELL-style) view of B2SR; ``-1`` pads ``tile_col_idx``."""

    tile_col_idx: torch.Tensor   # int32[n_tile_rows, max_tiles_per_row]
    bit_tiles: torch.Tensor      # int32[n_tile_rows, max_tiles_per_row, tile_dim]
    row_n_tiles: torch.Tensor    # int32[n_tile_rows]
    tile_dim: int
    n_rows: int
    n_cols: int

    @property
    def n_tile_rows(self) -> int:
        return int(self.tile_col_idx.shape[0])


@dataclasses.dataclass(frozen=True)
class B2SRBucketedEll:
    """Row-bucketed (SELL-style) ELL view: per-bucket static tiles-per-row.

    Tile-rows are grouped by tile count into power-of-two ranges; bucket
    ``b`` is a ``[rows_b, k_b]`` slab plus ``rows[b]``, the original
    tile-row ids. Empty tile-rows belong to no bucket.
    """

    col_idx: Tuple[torch.Tensor, ...]     # int32[rows_b, k_b] (-1 = padding)
    bit_tiles: Tuple[torch.Tensor, ...]   # int32[rows_b, k_b, tile_dim]
    rows: Tuple[torch.Tensor, ...]        # int32[rows_b]
    tile_dim: int
    n_rows: int
    n_cols: int
    n_tile_rows: int

    @property
    def n_buckets(self) -> int:
        return len(self.col_idx)


def tile_rows(m: B2SR) -> torch.Tensor:
    """Tile-row index of every stored tile (int64[n_tiles])."""
    counts = (m.tile_row_ptr[1:] - m.tile_row_ptr[:-1]).to(torch.int64)
    return torch.repeat_interleave(
        torch.arange(m.n_tile_rows, device=m.device), counts)


# ---------------------------------------------------------------------------
# Conversion (the cusparseXcsr2bsrNnz / csr2bsr analogue), on the device
# ---------------------------------------------------------------------------

def coo_to_b2sr(rows, cols, n_rows: int, n_cols: int, tile_dim: int = 32,
                device: DeviceLike = None) -> B2SR:
    """Convert a binary COO matrix to B2SR. Duplicate entries are OR-ed.

    ``np.bitwise_or.at`` becomes: dedup the (tile, row, bit) keys, then
    add the distinct bits into their words (a sum of distinct powers of
    two is their OR).
    """
    if tile_dim not in TILE_DIMS:
        raise ValueError(f"tile_dim must be one of {TILE_DIMS}, got {tile_dim}")
    dev = resolve_device(device)
    rows = torch.as_tensor(rows, device=dev).to(torch.int64)
    cols = torch.as_tensor(cols, device=dev).to(torch.int64)
    if rows.numel() and (int(rows.min()) < 0 or int(rows.max()) >= n_rows):
        raise ValueError("row index out of range")
    if cols.numel() and (int(cols.min()) < 0 or int(cols.max()) >= n_cols):
        raise ValueError("col index out of range")
    t = tile_dim
    n_tile_rows = ceil_div(n_rows, t)
    n_tile_cols = ceil_div(n_cols, t)

    tile_key = (rows // t) * n_tile_cols + cols // t
    bit_key = torch.unique(tile_key * (t * t) + (rows % t) * t + cols % t)
    tiles, inverse = torch.unique_consecutive(bit_key // (t * t),
                                              return_inverse=True)
    n_tiles = int(tiles.shape[0])
    word_idx = inverse * t + (bit_key % (t * t)) // t
    words = torch.zeros(n_tiles * t, dtype=torch.int64, device=dev)
    words.index_add_(0, word_idx, torch.ones_like(bit_key) << (bit_key % t))

    tile_tr = tiles // n_tile_cols
    ptr = torch.zeros(n_tile_rows + 1, dtype=torch.int64, device=dev)
    ptr[1:] = torch.cumsum(torch.bincount(tile_tr, minlength=n_tile_rows), 0)
    return B2SR(
        tile_row_ptr=ptr.to(torch.int32),
        tile_col_idx=(tiles % n_tile_cols).to(torch.int32),
        bit_tiles=to_int32(words).view(n_tiles, t),
        tile_dim=t, n_rows=n_rows, n_cols=n_cols,
        nnz=int(rows.shape[0]),
    )


def b2sr_to_coo(m: B2SR, chunk_words: int = 1 << 26
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """B2SR -> (rows, cols) int64 COO, in the reference's order.

    Unpacks ``chunk_words`` tile bits at a time, so a graph of tens of
    millions of tiles never materialises its whole ``[n_tiles, t, t]``.
    """
    t = m.tile_dim
    tr = tile_rows(m)
    tc = m.tile_col_idx.to(torch.int64)
    step = max(1, chunk_words // (t * t))
    out_r, out_c = [], []
    for s in range(0, m.n_tiles, step):
        p, r, c = unpack_bits(m.bit_tiles[s:s + step], t).nonzero(as_tuple=True)
        out_r.append(tr[s + p] * t + r)
        out_c.append(tc[s + p] * t + c)
    if not out_r:
        empty = torch.zeros(0, dtype=torch.int64, device=m.device)
        return empty, empty.clone()
    return torch.cat(out_r), torch.cat(out_c)


def transpose(m: B2SR) -> B2SR:
    """B2SR transpose: ``coo_to_b2sr`` of the swapped COO (canonical)."""
    rows, cols = b2sr_to_coo(m)
    mt = coo_to_b2sr(cols, rows, m.n_cols, m.n_rows, m.tile_dim, m.device)
    return dataclasses.replace(mt, nnz=m.nnz)


def _tile_slots(m: B2SR) -> Tuple[torch.Tensor, torch.Tensor]:
    """(tile-row, position within the row) of every stored tile."""
    tr = tile_rows(m)
    pos = torch.arange(m.n_tiles, device=m.device) - m.tile_row_ptr[tr].long()
    return tr, pos


def to_ell(m: B2SR) -> B2SREll:
    """CSR-over-tiles -> padded ELL view, as wide as the longest tile-row."""
    counts = (m.tile_row_ptr[1:] - m.tile_row_ptr[:-1]).to(torch.int32)
    k = max(int(counts.max()) if counts.numel() else 1, 1)
    n_tr, t = m.n_tile_rows, m.tile_dim
    col = torch.full((n_tr, k), -1, dtype=torch.int32, device=m.device)
    tiles = torch.zeros((n_tr, k, t), dtype=WORD, device=m.device)
    tr, pos = _tile_slots(m)
    col[tr, pos] = m.tile_col_idx
    tiles[tr, pos] = m.bit_tiles
    return B2SREll(tile_col_idx=col, bit_tiles=tiles, row_n_tiles=counts,
                   tile_dim=t, n_rows=m.n_rows, n_cols=m.n_cols)


def to_bucketed(m: B2SR, max_buckets: int = 8) -> B2SRBucketedEll:
    """B2SR -> row-bucketed (SELL-style) view, the reference's slabs.

    Built from the CSR-over-tiles directly (the reference goes through
    the single-max ELL, which on skewed graphs is far larger than the
    graph). Tile-rows are grouped by ``ceil(log2(count))``; past
    ``max_buckets`` ranges the widest merge into one hub slab.
    """
    counts = (m.tile_row_ptr[1:] - m.tile_row_ptr[:-1]).to(torch.int64)
    nonempty = torch.nonzero(counts > 0).flatten()
    cols_out, tiles_out, rows_out = [], [], []
    if nonempty.numel():
        # ceil(log2(c)) exactly: frexp(c - 1) has exponent ceil(log2(c))
        bidx = torch.frexp((counts[nonempty] - 1).double()).exponent.long()
        uniq = torch.unique(bidx)
        if uniq.numel() > max_buckets:
            keep = uniq[: max_buckets - 1]
            bidx = torch.where(torch.isin(bidx, keep), bidx,
                               uniq[max_buckets - 1])
            uniq = torch.unique(bidx)
        row_bucket = torch.full_like(counts, -1)
        row_bucket[nonempty] = bidx
        slot = torch.zeros_like(counts)
        tr, pos = _tile_slots(m)
        tile_bucket = row_bucket[tr]
        for b in uniq.tolist():
            rows_b = nonempty[bidx == b]
            k_b = int(counts[rows_b].max())
            slot[rows_b] = torch.arange(rows_b.numel(), device=m.device)
            sel = torch.nonzero(tile_bucket == b).flatten()
            col = torch.full((rows_b.numel(), k_b), -1, dtype=torch.int32,
                             device=m.device)
            tiles = torch.zeros((rows_b.numel(), k_b, m.tile_dim), dtype=WORD,
                                device=m.device)
            col[slot[tr[sel]], pos[sel]] = m.tile_col_idx[sel]
            tiles[slot[tr[sel]], pos[sel]] = m.bit_tiles[sel]
            cols_out.append(col)
            tiles_out.append(tiles)
            rows_out.append(rows_b.to(torch.int32))
    return B2SRBucketedEll(
        col_idx=tuple(cols_out), bit_tiles=tuple(tiles_out),
        rows=tuple(rows_out), tile_dim=m.tile_dim, n_rows=m.n_rows,
        n_cols=m.n_cols, n_tile_rows=m.n_tile_rows)


# ---------------------------------------------------------------------------
# Bit packing / unpacking of vectors and tiles
# ---------------------------------------------------------------------------

def pack_bitvector(x: torch.Tensor, tile_dim: int,
                   n_cols: Optional[int] = None) -> torch.Tensor:
    """Pack a dense 0/1 vector into per-tile words (int32, low tile_dim bits)."""
    t = tile_dim
    n = x.shape[0] if n_cols is None else n_cols
    n_pad = ceil_div(n, t) * t
    xb = torch.nn.functional.pad((x != 0).to(torch.int32),
                                 (0, n_pad - x.shape[0]))
    return pack_bits(xb.view(-1, t))


def unpack_bitvector(words: torch.Tensor, tile_dim: int, n: int,
                     dtype=torch.float32) -> torch.Tensor:
    return unpack_bits(words, tile_dim).reshape(-1)[:n].to(dtype)


#: Frontier *matrices* (the multi-source engine): the source axis packs
#: into whole 32-bit words whatever the tile_dim; tile_dim groups the
#: node axis, so a B2SR scheme gathers one ``[t, W]`` panel per tile column.
SOURCE_WORD_BITS = 32


def pack_frontier_matrix(x: torch.Tensor, tile_dim: int,
                         n_rows: Optional[int] = None) -> torch.Tensor:
    """Binarize + bit-pack a batch of frontiers ``[n, S]`` along the S axis.

    Returns ``int32[ceil(n/t), t, W]`` with ``W = ceil(S/32)``: entry
    ``[T, r, w]`` packs sources ``32w .. 32w+31`` of node ``T*t + r``,
    LSB first, so source bit 31 of a word lands in the sign bit. The
    trailing node and source pads are zero bits.
    """
    t = tile_dim
    n = x.shape[0] if n_rows is None else n_rows
    s = x.shape[1]
    n_tiles = ceil_div(n, t)
    w = ceil_div(max(s, 1), SOURCE_WORD_BITS)
    xb = torch.nn.functional.pad(
        (x != 0).to(torch.int32),
        (0, w * SOURCE_WORD_BITS - s, 0, n_tiles * t - x.shape[0]))
    return pack_bits(xb.view(n_tiles, t, w, SOURCE_WORD_BITS))


def unpack_frontier_matrix(words: torch.Tensor, n: int, n_sources: int,
                           dtype=torch.float32) -> torch.Tensor:
    """Inverse of :func:`pack_frontier_matrix`: ``[T, t, W]`` -> ``[n, S]``."""
    tiles, t, w = words.shape
    bits = unpack_bits(words, SOURCE_WORD_BITS)            # [T, t, W, 32]
    return bits.reshape(tiles * t, w * SOURCE_WORD_BITS)[
        :n, :n_sources].to(dtype)


def pack_bitmatrix(x: torch.Tensor, tile_dim: int,
                   n: Optional[int] = None) -> torch.Tensor:
    """Binarize (``x != 0``) and pack a dense ``[n, d]`` along the node
    axis: ``int32[ceil(n/t), d]``, word ``[c, j]`` bit ``r`` is entry
    ``[c*t + r, j]`` (the ``BitMatrix`` layout; the pad rows are 0)."""
    t = tile_dim
    n = x.shape[0] if n is None else n
    nt = ceil_div(n, t)
    bits = torch.nn.functional.pad((x != 0).to(torch.int32),
                                   (0, 0, 0, nt * t - x.shape[0]))
    return pack_bits(bits.view(nt, t, -1).transpose(1, 2))


def unpack_bitmatrix(words: torch.Tensor, tile_dim: int, n: int,
                     dtype=torch.float32) -> torch.Tensor:
    """Inverse of :func:`pack_bitmatrix`: ``[ceil(n/t), d]`` -> ``[n, d]``."""
    bits = unpack_bits(words, tile_dim)                  # [T, d, t]
    return bits.transpose(1, 2).reshape(-1, words.shape[1])[:n].to(dtype)


def unpack_tiles(tiles: torch.Tensor, tile_dim: int,
                 dtype=torch.float32) -> torch.Tensor:
    """Words ``[..., t]`` -> dense 0/1 ``[..., t, t]`` (row, col)."""
    return unpack_bits(tiles, tile_dim).to(dtype)


# ---------------------------------------------------------------------------
# Word reductions and packed tile grids (the SpGEMM C-side)
# ---------------------------------------------------------------------------

def or_reduce_words(words: torch.Tensor, dims) -> torch.Tensor:
    """Bitwise-OR reduction of int32 words over ``dims`` (the ∨-monoid)."""
    for d in sorted({d % words.dim() for d in dims}, reverse=True):
        out = torch.zeros_like(words.select(d, 0))
        for part in words.unbind(d):
            out = out | part
        words = out
    return words


def bit_transpose_words(tiles: torch.Tensor, tile_dim: int) -> torch.Tensor:
    """Per-tile bit transpose of words ``[..., t]``: unpack, swap, repack."""
    bits = unpack_bits(tiles, tile_dim)
    return pack_bits(bits.transpose(-1, -2))


def pack_dense_tiles(dense: torch.Tensor, tile_dim: int) -> torch.Tensor:
    """Dense 0/1 ``[n, m]`` -> packed tiles ``int32[ceil(n/t), ceil(m/t),
    t]``: word ``[R, C, r]`` bit ``c`` is entry ``[R*t + r, C*t + c]``
    (zero padded to whole tiles)."""
    t = tile_dim
    r_pad = ceil_div(dense.shape[0], t) * t
    c_pad = ceil_div(dense.shape[1], t) * t
    d = torch.nn.functional.pad((dense != 0).to(torch.int32),
                                (0, c_pad - dense.shape[1],
                                 0, r_pad - dense.shape[0]))
    return pack_bits(d.view(r_pad // t, t, c_pad // t, t).transpose(1, 2))


def ell_to_packed_grid(ell: B2SREll) -> torch.Tensor:
    """ELL view -> dense tile grid ``int32[n_tile_rows, n_tile_cols, t]``.

    Every real slot lands at its tile-column; a legal ELL row has distinct
    tile columns, so plain assignment is the reference's OR-merge.
    """
    r_n, _ = ell.tile_col_idx.shape
    grid = torch.zeros((r_n, ceil_div(ell.n_cols, ell.tile_dim),
                        ell.tile_dim), dtype=WORD,
                       device=ell.tile_col_idx.device)
    r, k = torch.nonzero(ell.tile_col_idx >= 0, as_tuple=True)
    grid[r, ell.tile_col_idx[r, k].long()] = ell.bit_tiles[r, k]
    return grid


def b2sr_to_packed_grid(m: B2SR) -> torch.Tensor:
    """B2SR -> dense tile grid ``int32[n_tile_rows, n_tile_cols, t]``."""
    grid = torch.zeros((m.n_tile_rows, m.n_tile_cols, m.tile_dim),
                       dtype=WORD, device=m.device)
    grid[tile_rows(m), m.tile_col_idx.long()] = m.bit_tiles
    return grid


def _from_tile_keys(keys: torch.Tensor, words: torch.Tensor, t: int,
                    n_rows: int, n_cols: int) -> B2SR:
    """B2SR from sorted tile keys ``row * n_tile_cols + col`` and their
    words; ``nnz`` is the number of set bits."""
    n_tc, n_tr = ceil_div(n_cols, t), ceil_div(n_rows, t)
    ptr = torch.zeros(n_tr + 1, dtype=torch.int64, device=words.device)
    ptr[1:] = torch.cumsum(torch.bincount(keys // n_tc, minlength=n_tr), 0)
    return B2SR(tile_row_ptr=ptr.to(torch.int32),
                tile_col_idx=(keys % n_tc).to(torch.int32),
                bit_tiles=words.contiguous(), tile_dim=t, n_rows=n_rows,
                n_cols=n_cols, nnz=count_bits(words))


def count_bits(words: torch.Tensor) -> int:
    """Set bits of int32 bit-pattern words, as a Python int."""
    return int(popcount(words).sum(dtype=torch.int64)) if words.numel() else 0


def packed_grid_to_b2sr(grid: torch.Tensor, n_rows: int, n_cols: int) -> B2SR:
    """Dense tile grid ``int32[R, C, t]`` -> B2SR, all-zero tiles dropped."""
    r_n, c_n, t = grid.shape
    if t not in TILE_DIMS:
        raise ValueError(f"tile_dim must be one of {TILE_DIMS}, got {t}")
    if r_n != ceil_div(n_rows, t) or c_n < ceil_div(n_cols, t):
        raise ValueError(f"grid {tuple(grid.shape)} inconsistent with "
                         f"({n_rows}, {n_cols}) at tile_dim {t}")
    tr, tc = torch.nonzero((grid != 0).any(-1), as_tuple=True)
    ptr = torch.zeros(r_n + 1, dtype=torch.int64, device=grid.device)
    ptr[1:] = torch.cumsum(torch.bincount(tr, minlength=r_n), 0)
    tiles = grid[tr, tc]
    return B2SR(tile_row_ptr=ptr.to(torch.int32),
                tile_col_idx=tc.to(torch.int32), bit_tiles=tiles,
                tile_dim=t, n_rows=n_rows, n_cols=n_cols,
                nnz=count_bits(tiles))


def tile_keys(m: B2SR) -> torch.Tensor:
    """``row * n_tile_cols + col`` of every stored tile (int64, sorted when
    each tile-row's columns are)."""
    return tile_rows(m) * m.n_tile_cols + m.tile_col_idx.long()


def combine_tiles(a: B2SR, b: B2SR, fn) -> B2SR:
    """``fn(a_words, b_words)`` tile by tile over the union of the two tile
    lists (a tile one side lacks reads as zero words); tiles that come
    out all zero are dropped. The sparse form of a word-wise operation
    on two packed grids."""
    if (a.tile_dim, a.n_rows, a.n_cols) != (b.tile_dim, b.n_rows, b.n_cols):
        raise ValueError(f"shape mismatch: {a.n_rows}x{a.n_cols} "
                         f"(t={a.tile_dim}) vs {b.n_rows}x{b.n_cols} "
                         f"(t={b.tile_dim})")
    keys, inv = torch.unique(torch.cat([tile_keys(a), tile_keys(b)]),
                             return_inverse=True)
    wa = torch.zeros((keys.shape[0], a.tile_dim), dtype=WORD, device=a.device)
    wb = torch.zeros_like(wa)
    wa[inv[:a.n_tiles]] = a.bit_tiles
    wb[inv[a.n_tiles:]] = b.bit_tiles
    w = fn(wa, wb)
    keep = (w != 0).any(-1)
    return _from_tile_keys(keys[keep], w[keep], a.tile_dim, a.n_rows,
                           a.n_cols)


def stack_rows(pieces, n_cols: int, tile_dim: int) -> B2SR:
    """Stack B2SR row blocks (each but the last a whole number of
    tile-rows) into one matrix; ``nnz`` counts the set bits."""
    t = tile_dim
    if not pieces:
        raise ValueError("stack_rows needs at least one piece")
    dev = pieces[0].device
    ptrs = [torch.zeros(1, dtype=torch.int64, device=dev)]
    for p in pieces:
        ptrs.append(p.tile_row_ptr[1:].long() + ptrs[-1][-1])
    tiles = torch.cat([p.bit_tiles for p in pieces])
    return B2SR(tile_row_ptr=torch.cat(ptrs).to(torch.int32),
                tile_col_idx=torch.cat([p.tile_col_idx for p in pieces]),
                bit_tiles=tiles.view(-1, t), tile_dim=t,
                n_rows=sum(p.n_rows for p in pieces), n_cols=n_cols,
                nnz=count_bits(tiles))
