"""Work items: a B2SR's tile-rows cut into runs of bounded work.

The row-product kernels (``bmv_bbb_push``, ``bmv_bff``, ``bmv_bbf``,
``spmm_bbb``, ``spmm_dense``, ``spmm_bbf``) give each warp one work
item, a run of consecutive tiles of one tile-row, instead of a whole
tile-row, so that
a hub tile-row (40,500 tiles and 552,282 set bits in tile-row 0 of R-MAT
scale 21 at t = 32) spreads over many warps instead of setting a floor
under the launch. Any cut gives the same result; the kernels merge the
items of a cut row themselves.

A ``b2sr_cuda`` registry row cuts once per stored orientation and
keeps the cut with it (:func:`items_for`), a sharded row once per
shard's row block (:func:`block_items`); kernels whose budgets agree
share one cut. The pull step also keeps each tile-row's lane occupancy
(:func:`lanes_for`): the lanes that some tile of the row can set.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.words import pack_bits, popcount

#: tiles whose set bits a cut by bits counts at a time
_POPCOUNT_CHUNK = 1 << 20
#: tiles whose non-zero words :func:`row_lanes` counts at a time (512 MB
#: of int32 counts at t = 32)
_LANES_CHUNK = 1 << 22


@dataclasses.dataclass(frozen=True)
class WorkItems:
    """A B2SR's tile-rows cut into runs of consecutive tiles.

    Item ``i`` holds tiles ``begin[i] .. begin[i + 1]`` of tile-row
    ``row[i]``; rows without tiles have no item. A row cut into several
    items gives each a scratch ``slot`` (-1 for an item that is its whole
    row), and ``cut_row``, ``cut_first``, ``cut_count`` list the cut rows
    with their first slot and their number of items.
    """

    row: torch.Tensor         # int32[n_items]
    begin: torch.Tensor       # int32[n_items + 1]
    slot: torch.Tensor        # int32[n_items]
    cut_row: torch.Tensor     # int32[n_cut]
    cut_first: torch.Tensor   # int32[n_cut]
    cut_count: torch.Tensor   # int32[n_cut]
    n_slots: int

    @property
    def n_items(self) -> int:
        return int(self.row.shape[0])


def cut_rows(tile_row_ptr: torch.Tensor, bit_tiles: torch.Tensor,
             budget: int, by_bits: bool = False) -> WorkItems:
    """Cut the tile-rows of CSR-over-tiles arrays into :class:`WorkItems`
    (on their device): runs of a row's tiles whose work adds up to at most
    ``budget`` (a single tile may exceed it). A tile's work is 1, or with
    ``by_bits`` its set bits plus one."""
    dev = tile_row_ptr.device
    n_tile_rows = tile_row_ptr.shape[0] - 1
    n_tiles = bit_tiles.shape[0]
    counts = (tile_row_ptr[1:] - tile_row_ptr[:-1]).to(torch.int64)
    rows = torch.repeat_interleave(torch.arange(n_tile_rows, device=dev),
                                   counts)
    if by_bits:     # in chunks: the popcount's temporaries are 4 B a word
        work = torch.ones(n_tiles, dtype=torch.int64, device=dev)
        for s in range(0, n_tiles, _POPCOUNT_CHUNK):
            work[s:s + _POPCOUNT_CHUNK] += popcount(
                bit_tiles[s:s + _POPCOUNT_CHUNK]).sum(1, dtype=torch.int64)
    else:
        work = torch.ones(n_tiles, dtype=torch.int64, device=dev)
    done = torch.cumsum(work, 0) - work              # before each tile
    part = (done - done[tile_row_ptr.long()[rows]]) // budget
    first = torch.ones(n_tiles, dtype=torch.bool, device=dev)
    first[1:] = (rows[1:] != rows[:-1]) | (part[1:] != part[:-1])
    starts = torch.nonzero(first).flatten()
    item_row = rows[starts]
    per_row = torch.bincount(item_row, minlength=n_tile_rows)
    cut = per_row[item_row] > 1
    slot = torch.where(cut, torch.cumsum(cut.long(), 0) - 1, -1)
    cut_rows_ = torch.nonzero(per_row > 1).flatten()
    row_first = torch.cumsum(per_row, 0) - per_row   # each row's first item
    i32 = torch.int32
    return WorkItems(row=item_row.to(i32),
                     begin=torch.cat([starts, starts.new_tensor(
                         [n_tiles])]).to(i32),
                     slot=slot.to(i32), cut_row=cut_rows_.to(i32),
                     cut_first=slot[row_first[cut_rows_]].to(i32),
                     cut_count=per_row[cut_rows_].to(i32),
                     n_slots=int(cut.sum()))


def work_items(m, budget: int, by_bits: bool = False) -> WorkItems:
    """:func:`cut_rows` of the B2SR ``m``."""
    return cut_rows(m.tile_row_ptr, m.bit_tiles, budget, by_bits)


def check_items(items: WorkItems, device: torch.device) -> None:
    """Raise unless ``items`` lie on ``device`` and are well formed."""
    if items.row.device != device or int(items.begin.shape[0]) != \
            items.n_items + 1:
        raise ValueError(f"work items on {items.row.device} with "
                         f"{items.begin.shape[0]} begins for "
                         f"{items.n_items} items; the matrix is on "
                         f"{device}")


def block_items(holder, budget: int, by_bits: bool = False) -> WorkItems:
    """The work items of ``holder.b2sr`` for this cut, kept in
    ``holder.cache``: a graph's stored orientation, or a shard's row block
    (``core.partition.ShardBlock``). A row's cut depends on its own tiles
    only, so a block's items cut each row as the whole graph's do."""
    cache = holder.cache
    key = ("work_items", budget, by_bits)
    if key not in cache:
        cache[key] = work_items(holder.b2sr, budget, by_bits)
    return cache[key]


def items_for(g, budget: int, by_bits: bool = False) -> WorkItems:
    """The work items of ``g``'s B2SR for this cut, kept with its stored
    orientation (kernels that cut alike share them)."""
    return block_items(g.fwd, budget, by_bits)


def row_lanes(tile_row_ptr: torch.Tensor,
              bit_tiles: torch.Tensor) -> torch.Tensor:
    """int32[R] words: bit ``r`` of word ``i`` is set iff some tile of
    tile-row ``i`` has a bit in its word ``r``. A clear lane is set by no
    mxv over these arrays, so the pull step need not wait for it (a
    vertex without in-edges, as R-MAT's isolated vertices, would keep
    its row walking to the end)."""
    dev = tile_row_ptr.device
    n_tile_rows = tile_row_ptr.shape[0] - 1
    counts = (tile_row_ptr[1:] - tile_row_ptr[:-1]).to(torch.int64)
    rows = torch.repeat_interleave(torch.arange(n_tile_rows, device=dev),
                                   counts)
    seen = torch.zeros((n_tile_rows, bit_tiles.shape[1]), dtype=torch.int32,
                       device=dev)
    for s in range(0, bit_tiles.shape[0], _LANES_CHUNK):
        seen.index_add_(0, rows[s:s + _LANES_CHUNK],
                        (bit_tiles[s:s + _LANES_CHUNK] != 0).to(torch.int32))
    return pack_bits(seen)


def block_lanes(holder) -> torch.Tensor:
    """:func:`row_lanes` of ``holder.b2sr``, kept in ``holder.cache``."""
    cache = holder.cache
    if "row_lanes" not in cache:
        m = holder.b2sr
        cache["row_lanes"] = row_lanes(m.tile_row_ptr, m.bit_tiles)
    return cache["row_lanes"]


def lanes_for(g) -> torch.Tensor:
    """:func:`row_lanes` of ``g``'s B2SR, kept with its stored
    orientation."""
    return block_lanes(g.fwd)
