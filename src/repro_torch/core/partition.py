"""Row-partitioned B2SR: the shards of a sharded ``GraphMatrix``.

The torch twin of ``repro.core.partition``. A graph's tile-row axis is
split into ``n_shards`` **contiguous ragged blocks** by a greedy
prefix-sum split over the per-tile-row tile counts, so each shard's work
is within one row's cost of even (``balance()`` near 1.0 on heavy-hub
graphs). The split, the statistics, ``gather_idx`` and the exchange plans
are the reference's, computed with numpy on the host, field for field.

What the kernels read differs. The reference stacks every shard's ELL
slab into one ``[P, R, K, t]`` array for ``jax.shard_map``; here each
shard is a **row block**: the CSR-over-tiles arrays of its tile rows
``[row_starts[p], row_starts[p+1])`` at full ``n_cols``
(:class:`ShardBlock`), on its slot's device, with the work items the
kernels cut from it kept beside it. A block's arrays are views of the
whole graph's where the slot's device is the graph's. Because the blocks
are contiguous, their outputs concatenated in shard order are the global
rows; ``gather_idx`` is kept as the partition's record. The stacked
padded ELL slabs (and the harmonised bucket slabs) are built on first use,
for the ``b2sr`` word schemes only: on a skewed graph the single-max ELL
is far larger than the graph, and the ``b2sr_cuda`` rows never read it.

:func:`build_exchange_plan` derives the exchange combine's schedule: the
column words each shard's block touches, the per-ring-offset send and
receive index sets that move only those words, and the redistribution of
the output rows to equal-block owners.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.core.b2sr import (B2SR, B2SREll, TILE_DIMS, ceil_div,
                                   count_bits, to_ell)


class ShardBlock:
    """One shard's tile rows ``[lo, hi)`` as a B2SR on its slot's device.

    ``cache`` keeps what the ``b2sr_cuda`` rows derive from ``b2sr`` once
    (work items, the pull step's lane occupancy), as a stored orientation
    of an unsharded graph does. ``device`` is the slot's (two slots of one
    card are two shards, and ``cpu:0`` and ``cpu:1`` two slots of the
    host).
    """

    def __init__(self, b2sr: B2SR, lo: int, hi: int, device: torch.device):
        self.b2sr = b2sr
        self.lo, self.hi = lo, hi
        self.device = device
        self.cache: Dict = {}

    @property
    def n_tile_rows(self) -> int:
        return self.hi - self.lo


def _row_block(mat: B2SR, ptr: np.ndarray, lo: int, hi: int,
               device: torch.device) -> B2SR:
    """Tile rows ``[lo, hi)`` of ``mat`` at full width, on ``device``."""
    b, e = int(ptr[lo]), int(ptr[hi])
    t = mat.tile_dim
    tiles = mat.bit_tiles[b:e].to(device)
    return B2SR(tile_row_ptr=(mat.tile_row_ptr[lo:hi + 1] - b).to(device),
                tile_col_idx=mat.tile_col_idx[b:e].to(device),
                bit_tiles=tiles, tile_dim=t,
                n_rows=max(0, min(hi * t, mat.n_rows) - lo * t),
                n_cols=mat.n_cols, nnz=count_bits(tiles))


def _ell_to_b2sr(ell: B2SREll) -> B2SR:
    """The CSR-over-tiles arrays of an ELL view (tile order kept)."""
    valid = ell.tile_col_idx >= 0
    ptr = torch.zeros(ell.n_tile_rows + 1, dtype=torch.int64,
                      device=ell.tile_col_idx.device)
    ptr[1:] = torch.cumsum(valid.sum(1), 0)
    tiles = ell.bit_tiles[valid].reshape(-1, ell.tile_dim)
    return B2SR(tile_row_ptr=ptr.to(torch.int32),
                tile_col_idx=ell.tile_col_idx[valid].to(torch.int32),
                bit_tiles=tiles.contiguous(), tile_dim=ell.tile_dim,
                n_rows=ell.n_rows, n_cols=ell.n_cols,
                nnz=count_bits(tiles))


@dataclasses.dataclass
class PartitionedB2SR:
    """Ragged contiguous tile-row blocks of one matrix, one per shard.

    Shard ``p`` owns the global tile rows ``[row_starts[p],
    row_starts[p+1])`` (``blocks[p]``); ``rows_per_shard`` is the largest
    block; ``gather_idx`` maps each global tile row to its position
    ``p * rows_per_shard + local`` in the reference's stacked layout.
    The stacked slabs (``tile_col_idx``, ``bit_tiles``, ``row_n_tiles``
    and, when ``with_buckets``, the harmonised ``bucket_*`` slabs) are
    the reference's, built from ``source`` on first use.
    """

    source: B2SR
    blocks: Tuple[ShardBlock, ...]
    gather_idx: np.ndarray            # int32[n_tile_rows]
    tile_dim: int
    n_rows: int
    n_cols: int
    n_tile_rows: int
    row_starts: Tuple[int, ...]
    shard_tiles: Tuple[int, ...]
    cut_tiles: int
    with_buckets: bool = True
    max_buckets: int = 8
    _slabs: Optional[dict] = dataclasses.field(default=None, repr=False)
    #: per-shard torch views of the slabs, by shard
    _views: Dict[int, tuple] = dataclasses.field(default_factory=dict,
                                                 repr=False)

    @property
    def n_shards(self) -> int:
        return len(self.blocks)

    @property
    def rows_per_shard(self) -> int:
        return max(1, max(self.block_rows(p) for p in range(self.n_shards)))

    @property
    def n_tile_cols(self) -> int:
        return ceil_div(self.n_cols, self.tile_dim)

    def devices(self) -> Tuple[torch.device, ...]:
        return tuple(b.device for b in self.blocks)

    def n_tiles(self) -> int:
        return sum(self.shard_tiles)

    def block_rows(self, p: int) -> int:
        """Real (unpadded) tile rows owned by shard ``p``."""
        return self.row_starts[p + 1] - self.row_starts[p]

    def balance(self) -> float:
        """max/mean tiles per shard; 1.0 == perfectly even load."""
        total = self.n_tiles()
        if total == 0:
            return 1.0
        return max(self.shard_tiles) / (total / self.n_shards)

    def edge_cut(self) -> float:
        """Fraction of tiles whose tile-column lies outside the owning
        shard's own row block."""
        total = self.n_tiles()
        return 0.0 if total == 0 else self.cut_tiles / total

    # -- the reference's stacked slabs (the b2sr word schemes) ---------------
    def _stacked(self) -> dict:
        if self._slabs is None:
            self._slabs = _stack(self)
        return self._slabs

    @property
    def slab_width(self) -> int:
        return int(self._stacked()["col"].shape[2])

    @property
    def tile_col_idx(self) -> np.ndarray:
        return self._stacked()["col"]

    @property
    def bit_tiles(self) -> np.ndarray:
        return self._stacked()["tiles"]

    @property
    def row_n_tiles(self) -> np.ndarray:
        return self._stacked()["counts"]

    @property
    def bucket_col_idx(self) -> Tuple[np.ndarray, ...]:
        return self._stacked()["buckets"][0]

    @property
    def bucket_bit_tiles(self) -> Tuple[np.ndarray, ...]:
        return self._stacked()["buckets"][1]

    @property
    def bucket_rows(self) -> Tuple[np.ndarray, ...]:
        return self._stacked()["buckets"][2]

    @property
    def n_buckets(self) -> int:
        return len(self.bucket_col_idx)

    def slab_view(self, p: int) -> tuple:
        """Shard ``p``'s slabs as torch tensors on its device: ``(col
        [R, K], tiles [R, K, t], buckets)``, ``buckets`` a tuple of
        ``(col [rb, kb], tiles [rb, kb, t], rows [rb])``, pad rows -> R."""
        if p not in self._views:
            dev = self.blocks[p].device

            def on(a):
                return torch.from_numpy(np.ascontiguousarray(a[p])).to(dev)

            buckets = tuple((on(c), on(t), on(r).long()) for c, t, r in zip(
                self.bucket_col_idx, self.bucket_bit_tiles,
                self.bucket_rows))
            self._views[p] = (on(self.tile_col_idx), on(self.bit_tiles),
                              buckets)
        return self._views[p]


def _split_starts(counts: np.ndarray, n_shards: int,
                  balanced: bool) -> Tuple[int, ...]:
    """Block boundaries: greedy prefix-sum split over per-row tile counts.

    Boundary ``p`` lands where the cumulative tile count crosses ``p/P``
    of the total, rounded to the closer side of the target. Degenerate
    inputs (no tiles, one shard, ``balanced=False``) take equal-row
    blocks.
    """
    n_tr = int(counts.shape[0])
    total = int(counts.sum())
    if not balanced or n_shards == 1 or total == 0 or n_tr == 0:
        r_eq = max(ceil_div(n_tr, n_shards), 1)
        return tuple(min(p * r_eq, n_tr) for p in range(n_shards)) + (n_tr,)
    cum = np.cumsum(counts.astype(np.int64))
    targets = total * np.arange(1, n_shards, dtype=np.float64) / n_shards
    bounds = np.searchsorted(cum, targets, side="left") + 1
    bounds = np.minimum(np.maximum.accumulate(bounds), n_tr)
    for i, b in enumerate(bounds):
        if b >= 2 and abs(cum[b - 2] - targets[i]) < abs(cum[b - 1]
                                                         - targets[i]):
            bounds[i] = b - 1
    bounds = np.minimum(np.maximum.accumulate(bounds), n_tr)
    return (0, *(int(b) for b in bounds), n_tr)


def partition_rows(mat: Union[B2SR, B2SREll], n_shards: int,
                   with_buckets: bool = True, max_buckets: int = 8,
                   balanced: bool = True,
                   devices: Optional[Sequence[torch.device]] = None
                   ) -> PartitionedB2SR:
    """Split a B2SR (or its ELL view) into ``n_shards`` row blocks.

    Tile rows are split into contiguous **nnz-balanced** ragged blocks
    (``balanced=False``: equal blocks); shard ``p``'s block is placed on
    ``devices[p]`` (default: the matrix's device). Any ``n_shards >= 1``
    works, counts larger than the tile-row axis included (trailing
    shards own empty blocks).
    """
    if n_shards < 1:
        raise ValueError(f"n_shards must be >= 1, got {n_shards}")
    m = _ell_to_b2sr(mat) if isinstance(mat, B2SREll) else mat
    t = m.tile_dim
    if t not in TILE_DIMS:
        raise ValueError(f"tile_dim must be one of {TILE_DIMS}, got {t}")
    devices = (tuple(torch.device(d) for d in devices)
               if devices is not None else (m.device,) * n_shards)
    if len(devices) != n_shards:
        raise ValueError(f"{len(devices)} devices for {n_shards} shards")
    n_tr = m.n_tile_rows
    ptr = m.tile_row_ptr.cpu().numpy().astype(np.int64)
    starts = _split_starts(np.diff(ptr), n_shards, balanced)
    r_max = max(1, max(starts[p + 1] - starts[p] for p in range(n_shards)))
    gidx = np.zeros(n_tr, np.int32)
    blocks, shard_tiles = [], []
    cut = 0
    for p in range(n_shards):
        lo, hi = starts[p], starts[p + 1]
        gidx[lo:hi] = p * r_max + np.arange(hi - lo, dtype=np.int32)
        c = m.tile_col_idx[int(ptr[lo]):int(ptr[hi])]
        shard_tiles.append(int(ptr[hi] - ptr[lo]))
        # a tile is local to shard p if its tile-col falls inside the
        # shard's own row block (the square-matrix notion)
        cut += int(((c < lo) | (c >= hi)).sum())
        blocks.append(ShardBlock(_row_block(m, ptr, lo, hi, devices[p]),
                                 lo, hi, devices[p]))
    return PartitionedB2SR(
        source=m, blocks=tuple(blocks), gather_idx=gidx, tile_dim=t,
        n_rows=m.n_rows, n_cols=m.n_cols, n_tile_rows=n_tr,
        row_starts=tuple(int(s) for s in starts),
        shard_tiles=tuple(shard_tiles), cut_tiles=cut,
        with_buckets=with_buckets, max_buckets=max_buckets)


def _stack(part: PartitionedB2SR) -> dict:
    """The reference's stacked per-shard ELL slabs (numpy; words as int32
    bit patterns), padded to ``rows_per_shard`` rows and the global
    slab width, with the harmonised bucket slabs when asked for."""
    ell = to_ell(part.source)
    col_g = ell.tile_col_idx.cpu().numpy()
    tiles_g = ell.bit_tiles.cpu().numpy()
    counts_g = ell.row_n_tiles.cpu().numpy().astype(np.int32)
    P, r_max, t = part.n_shards, part.rows_per_shard, part.tile_dim
    k = col_g.shape[1]
    col = np.full((P, r_max, k), -1, np.int32)
    tiles = np.zeros((P, r_max, k, t), np.int32)
    counts = np.zeros((P, r_max), np.int32)
    for p in range(P):
        lo, hi = part.row_starts[p], part.row_starts[p + 1]
        col[p, :hi - lo] = col_g[lo:hi]
        tiles[p, :hi - lo] = tiles_g[lo:hi]
        counts[p, :hi - lo] = counts_g[lo:hi]
    buckets = (_harmonised_buckets(col, tiles, counts, t, part.max_buckets)
               if part.with_buckets else ((), (), ()))
    return {"col": col, "tiles": tiles, "counts": counts,
            "buckets": buckets}


def _harmonised_buckets(col: np.ndarray, tiles: np.ndarray,
                        counts: np.ndarray, t: int, max_buckets: int):
    """Per-shard SELL buckets with one global bucket structure.

    Bucket boundaries (power-of-two count ranges, merged to
    ``max_buckets``) and slab widths come from the global count
    histogram, so bucket ``b`` means the same range and width on every
    shard; each bucket's slab is padded to the largest per-shard row
    count, padding rows pointing at the garbage row ``rows_per_shard``.
    """
    n_shards, r_max = counts.shape
    nonempty = counts > 0
    if not nonempty.any():
        return (), (), ()
    bidx = np.full(counts.shape, -1, np.int64)
    bidx[nonempty] = np.ceil(np.log2(counts[nonempty])).astype(np.int64)
    uniq = np.sort(np.unique(bidx[nonempty]))
    if uniq.size > max_buckets:
        keep = uniq[: max_buckets - 1]
        hub = uniq[max_buckets - 1]
        sel = nonempty & ~np.isin(bidx, keep)
        bidx[sel] = hub
        uniq = np.sort(np.unique(bidx[nonempty]))

    cols_out, tiles_out, rows_out = [], [], []
    for b in uniq:
        per_shard: List[np.ndarray] = []
        k_b = 1
        for p in range(n_shards):
            local = np.flatnonzero(bidx[p] == b)
            per_shard.append(local)
            if local.size:
                k_b = max(k_b, int(counts[p, local].max()))
        rb = max(max(len(ix) for ix in per_shard), 1)
        c_slab = np.full((n_shards, rb, k_b), -1, np.int32)
        t_slab = np.zeros((n_shards, rb, k_b, t), np.int32)
        r_slab = np.full((n_shards, rb), r_max, np.int32)
        for p, local in enumerate(per_shard):
            if not local.size:
                continue
            c_slab[p, : local.size] = col[p, local, :k_b]
            t_slab[p, : local.size] = tiles[p, local, :k_b]
            r_slab[p, : local.size] = local
        cols_out.append(c_slab)
        tiles_out.append(t_slab)
        rows_out.append(r_slab)
    return tuple(cols_out), tuple(tiles_out), tuple(rows_out)


def unpartition(part: PartitionedB2SR) -> B2SR:
    """Reassemble the global B2SR from the shards' row blocks.

    The exact inverse of :func:`partition_rows`: the blocks' arrays are
    concatenated in shard order (tile order within each row kept), on the
    first shard's device.
    """
    dev = part.blocks[0].device
    ptrs = [torch.zeros(1, dtype=torch.int64, device=dev)]
    done = 0
    for b in part.blocks:
        ptrs.append(b.b2sr.tile_row_ptr[1:].to(dev).long() + done)
        done += b.b2sr.n_tiles
    tiles = torch.cat([b.b2sr.bit_tiles.to(dev) for b in part.blocks])
    return B2SR(
        tile_row_ptr=torch.cat(ptrs).to(torch.int32),
        tile_col_idx=torch.cat([b.b2sr.tile_col_idx.to(dev)
                                for b in part.blocks]),
        bit_tiles=tiles.view(-1, part.tile_dim), tile_dim=part.tile_dim,
        n_rows=part.n_rows, n_cols=part.n_cols, nnz=count_bits(tiles))


# ---------------------------------------------------------------------------
# Exchange plans: the schedule of combine="exchange"
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ExchangePlan:
    """The exchange combine's static schedule (the reference's fields).

    The operand is split in equal blocks of ``c_eq`` tile-columns, one
    per shard; each shard assembles only the words its block touches (its
    own block plus one send per non-empty ring offset), computes its
    ragged row block, and sends its output rows to their equal-block
    owners (``r_eq`` tile rows each). Every index array is ``[P, W]``
    (row ``p`` is shard ``p``'s), padding lanes aimed at a garbage slot:
    the zero row appended to a sender's block (``c_eq``, or
    ``rows_per_shard`` on the output side) and the dropped row appended
    to a receiver's buffer (``n_tc_pad``, or ``r_eq``).
    """

    n_shards: int
    c_eq: int
    r_eq: int
    n_tc_pad: int
    rhs_offsets: Tuple[int, ...]
    rhs_send_idx: Tuple[np.ndarray, ...]
    rhs_recv_pos: Tuple[np.ndarray, ...]
    out_offsets: Tuple[int, ...]
    out_send_idx: Tuple[np.ndarray, ...]
    out_recv_pos: Tuple[np.ndarray, ...]
    self_src: np.ndarray
    self_dst: np.ndarray
    rhs_lanes: int
    out_lanes: int
    gather_lanes: int
    #: the index arrays as int64 tensors on each shard's device, by
    #: (field, offset position, shard)
    on_device: Dict = dataclasses.field(default_factory=dict, repr=False,
                                        compare=False)

    def exchanged_lanes(self) -> int:
        return self.rhs_lanes + self.out_lanes

    def index(self, name: str, i: int, p: int, device: torch.device,
              clamp: Optional[int] = None,
              block: Optional[int] = None) -> torch.Tensor:
        """Row ``p`` of index array ``name`` (``i``-th offset's, or the
        self copy's with ``i = 0``) on ``device``, kept: with ``clamp``,
        capped at it (a sender's padding lanes then read a real row);
        with ``block``, as positions in the concatenation of the owners'
        blocks, ``block`` rows each, padding lanes on the row past the
        last block."""
        key = (name, i, p, device, clamp, block)
        if key not in self.on_device:
            a = getattr(self, name)
            row = (a[i] if isinstance(a, tuple) else a)[p].astype(np.int64)
            if clamp is not None:
                row = np.minimum(row, clamp)
            if block is not None:
                row = np.where(row == block, self.n_shards * block,
                               row + p * block)
            self.on_device[key] = torch.from_numpy(row).to(device)
        return self.on_device[key]


def build_exchange_plan(part: PartitionedB2SR) -> Optional[ExchangePlan]:
    """Derive the exchange schedule from the blocks' column words.

    Returns None for a single shard (nothing to exchange: the gather
    combine moves nothing there).
    """
    P = part.n_shards
    if P == 1:
        return None
    n_tc = part.n_tile_cols
    n_tr = part.n_tile_rows
    r_max = part.rows_per_shard
    c_eq = max(ceil_div(n_tc, P), 1)
    r_eq = max(ceil_div(n_tr, P), 1)
    n_tc_pad = P * c_eq

    # the operand words shard p's block touches
    need = [torch.unique(b.b2sr.tile_col_idx).cpu().numpy().astype(np.int64)
            for b in part.blocks]
    # need[p] split by owner q = word // c_eq; ring offset o sends q -> q+o
    need_from = [[n_p[(n_p // c_eq) == q] for q in range(P)]
                 for n_p in need]
    rhs_offsets, rhs_send, rhs_recv = [], [], []
    rhs_lanes = 0
    for o in range(1, P):
        w_o = max(len(need_from[(q + o) % P][q]) for q in range(P))
        if w_o == 0:
            continue
        send = np.full((P, w_o), c_eq, np.int32)        # garbage: pad row
        recv = np.full((P, w_o), n_tc_pad, np.int32)    # garbage: drop row
        for q in range(P):
            dst = (q + o) % P
            words = need_from[dst][q]
            send[q, : len(words)] = words - q * c_eq
            recv[dst, : len(words)] = words
        rhs_offsets.append(o)
        rhs_send.append(send)
        rhs_recv.append(recv)
        rhs_lanes += P * w_o

    # output redistribution: shard q computed global rows
    # [row_starts[q], row_starts[q+1]); owner p holds [p*r_eq, (p+1)*r_eq)
    overlaps = {}
    for q in range(P):
        lo_q, hi_q = part.row_starts[q], part.row_starts[q + 1]
        for p in range(P):
            lo = max(lo_q, p * r_eq)
            hi = min(hi_q, (p + 1) * r_eq)
            if hi > lo:
                overlaps[(q, p)] = (lo, hi)
    w_s = max((hi - lo for (q, p), (lo, hi) in overlaps.items() if q == p),
              default=0)
    self_src = np.full((P, max(w_s, 1)), r_max, np.int32)
    self_dst = np.full((P, max(w_s, 1)), r_eq, np.int32)
    for p in range(P):
        lo, hi = overlaps.get((p, p), (0, 0))
        m = hi - lo
        if m:
            self_src[p, :m] = np.arange(lo, hi) - part.row_starts[p]
            self_dst[p, :m] = np.arange(lo, hi) - p * r_eq

    out_offsets, out_send, out_recv = [], [], []
    out_lanes = 0
    for o in range(1, P):
        pairs = [(q, (q + o) % P) for q in range(P)]
        w_o = max((overlaps[(q, p)][1] - overlaps[(q, p)][0]
                   for (q, p) in pairs if (q, p) in overlaps), default=0)
        if w_o == 0:
            continue
        send = np.full((P, w_o), r_max, np.int32)
        recv = np.full((P, w_o), r_eq, np.int32)
        for q, p in pairs:
            if (q, p) not in overlaps:
                continue
            lo, hi = overlaps[(q, p)]
            m = hi - lo
            send[q, :m] = np.arange(lo, hi) - part.row_starts[q]
            recv[p, :m] = np.arange(lo, hi) - p * r_eq
        out_offsets.append(o)
        out_send.append(send)
        out_recv.append(recv)
        out_lanes += P * w_o

    return ExchangePlan(
        n_shards=P, c_eq=c_eq, r_eq=r_eq, n_tc_pad=n_tc_pad,
        rhs_offsets=tuple(rhs_offsets), rhs_send_idx=tuple(rhs_send),
        rhs_recv_pos=tuple(rhs_recv),
        out_offsets=tuple(out_offsets), out_send_idx=tuple(out_send),
        out_recv_pos=tuple(out_recv), self_src=self_src, self_dst=self_dst,
        rhs_lanes=rhs_lanes, out_lanes=out_lanes,
        gather_lanes=P * (P - 1) * r_max)


def mesh_fingerprint(mesh, axes: Tuple[str, ...]) -> Tuple:
    """Hashable identity of (mesh, shard axes) for plan-cache keys.

    Each slot is named by its position and its device's ``(type,
    index)``, so two meshes that repeat one device in different shapes or
    orders never share a plan.
    """
    return (
        tuple(mesh.axis_names),
        tuple(int(s) for s in mesh.devices.shape),
        tuple(axes),
        tuple((i, d.type, d.index) for i, d in enumerate(mesh.devices.flat)),
    )


def shard_count(mesh, axes: Tuple[str, ...]) -> int:
    """Product of the mesh-axis sizes the partition shards over."""
    sizes = dict(zip(mesh.axis_names, mesh.devices.shape))
    missing = [a for a in axes if a not in sizes]
    if missing:
        raise ValueError(f"mesh has no axis {missing}; axes are "
                         f"{tuple(mesh.axis_names)}")
    p = 1
    for a in axes:
        p *= int(sizes[a])
    return p


def shard_devices(mesh, axes: Tuple[str, ...]) -> Tuple[torch.device, ...]:
    """The device of each of the ``shard_count(mesh, axes)`` shards: the
    slots along ``axes`` (row-major) at index 0 of every other axis,
    which the reference's shards are replicated over."""
    names = tuple(mesh.axis_names)
    shard_count(mesh, axes)
    idx = tuple(slice(None) if a in axes else 0 for a in names)
    sub = mesh.devices[idx]
    kept = [a for a in names if a in axes]
    sub = np.moveaxis(np.asarray(sub, dtype=object),
                      [kept.index(a) for a in axes], range(len(axes)))
    return tuple(sub.flat)
