"""The sharded rows: each Table row over a row-partitioned graph.

The torch twin of ``repro.core.ops_sharded``. A graph sharded with
``GraphMatrix.shard(mesh)`` resolves to these rows (``sharded=True``).
Each runs, for every shard ``p``, the same per-block math its unsharded
twin runs on the whole graph: the torch word schemes of
``repro_torch.core.ops`` over the shard's stacked ELL slab (``b2sr``) or
the hand kernel that the unsharded ``b2sr_cuda`` row launches, over the
shard's row block (:class:`~repro_torch.core.partition.ShardBlock`) with
the work items kept beside it (``b2sr_cuda``). One process drives every
shard on its slot's device (single-controller execution) and does the
collectives as copies between slots; a shard with no tile rows computes
nothing. Three combines:

``combine="gather"`` (the default)
  the operand is copied to every shard's device, each shard computes its
  block's rows, and the blocks are concatenated in shard order on the
  first slot: contiguous blocks give the global row order directly.
``combine="psum"``
  the per-shard partial sums are added in shard order on the first slot
  (the triangle count, in int64).
``combine="exchange"``
  the operand is split in equal blocks of ``c_eq`` tile-columns, one per
  shard; each shard assembles the words its block touches from its own
  block and one ``index_select`` → ``to`` → ``index_copy_`` per non-empty
  ring offset of the :class:`~repro_torch.core.partition.ExchangePlan`
  (padding lanes land in a dropped slot), computes, and its output rows
  go to their equal-block owners the same way. The owners' blocks are
  then concatenated on the first slot: the result is returned there in
  the single-device layout, where the reference returns a device-sharded
  array, and the next call splits its operand again.

Masks are applied after the combine (``apply_output_mask`` and the word
ANDs), as the reference's rows do, except on the pull rows, whose early
exit reads the mask: ``bmv_bbb_pull`` takes each block's slice of the
mask words and the block's lane occupancy. The graph SpGEMM and count
rows and the triangle row take the gather and psum combines only (their
right-hand side has no column-word layout to exchange). The ``csr``
backend registers no sharded rows.

``row_chunk`` is rejected on every sharded row: the shards themselves are
the memory bound (``dispatch.reject_sharded_row_chunk`` raises before any
staging; the checks here are backstops). A kernel's ``KernelError``
propagates; no row falls back to a plain version.

Comm accounting: every sharded call adds the reference's static element
counts to ``gather_words_total`` or ``exchange_words_total{op,backend,
shards}``, annotates the ambient trace span, and adds the bytes to a plan
counted by ``repro_torch.obs.cost``. The counts are the reference's: the
copies that put the operand's blocks on their slots and that bring the
result to the first slot are not counted, as the reference's operand
arrives sharded and its result stays sharded.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence

import torch

from repro_torch.core import b2sr as b2sr_mod
from repro_torch.core.b2sr import (B2SR, B2SREll, ceil_div,
                                   ell_to_packed_grid, packed_grid_to_b2sr,
                                   stack_rows, to_ell)
from repro_torch.core.dispatch import BOTH, apply_output_mask, register
from repro_torch.core.ops import (_apply_dense_mask, _bmv_bbb_block,
                                  _bmv_bbf_block, _bmv_bff_block,
                                  _count_grid_to_dense, _mxm_bbb_block,
                                  _mxm_bbf_block, _spmm_bbb_block,
                                  _spmm_bbf_block, _spmm_block,
                                  apply_frontier_mask, apply_grid_mask,
                                  bff_setup)
from repro_torch.core.partition import (ExchangePlan, PartitionedB2SR,
                                        ShardBlock, _row_block,
                                        partition_rows)
from repro_torch.core.words import unpack_bits

_CUDA = "b2sr_cuda"


def _no_row_chunk(call) -> None:
    if call.row_chunk is not None:
        raise ValueError(
            "row_chunk is not supported on the sharded path — the row "
            "partition already bounds per-device memory (unshard() first "
            "if chunked evaluation is required)")


def _combine_for(g, part: Optional[PartitionedB2SR] = None) -> str:
    """Exchange only on the graph's own forward partition (the transposed
    view carries its own plan) and only where a plan exists (more than one
    shard); gather for any side partition and for single-shard meshes."""
    if (g.comm == "exchange" and (part is None or part is g.partitioned)
            and g.xplan is not None):
        return "exchange"
    return "gather"


_COMM_LABELS = ("op", "backend", "shards")


def _record_comm(g, part: PartitionedB2SR, combine: str, op: str, n: int,
                 itemsize: int) -> None:
    """The static comm volume of one sharded call (see the module doc):
    ``n`` elements, of ``itemsize`` bytes each for the cost count."""
    if part.n_shards <= 1:
        return
    from repro_torch.obs import cost as obs_cost
    from repro_torch.obs import metrics as obs_metrics
    from repro_torch.obs import trace as obs_trace
    if not obs_metrics.enabled():
        return
    obs_cost.add_wire_bytes(n * itemsize)
    reg = obs_metrics.get_registry()
    labels = {"op": op, "backend": g.backend, "shards": part.n_shards}
    if combine == "exchange":
        reg.counter("exchange_words_total",
                    "elements moved by exchange-mode collectives",
                    _COMM_LABELS).inc(n, **labels)
        obs_trace.annotate(comm="exchange", exchanged_words=n)
    else:
        reg.counter("gather_words_total",
                    "elements moved by gather/psum-mode collectives",
                    _COMM_LABELS).inc(n, **labels)
        obs_trace.annotate(comm=combine, gathered_words=n)


def _ell_words(m: B2SR) -> int:
    """Elements of the reference's ELL view of ``m`` (column indices,
    tiles and row counts), which its graph rows replicate."""
    counts = m.tile_row_ptr[1:] - m.tile_row_ptr[:-1]
    k = max(int(counts.max()) if counts.numel() else 1, 1)
    return m.n_tile_rows * (k * (1 + m.tile_dim) + 1)


def _live(part: PartitionedB2SR, p: int) -> bool:
    """Whether shard ``p`` computes (a block of no tile rows does not,
    unless the matrix has none at all)."""
    return part.block_rows(p) > 0 or (p == 0 and part.n_tile_rows == 0)


def _sharded_call(g, local_fn: Callable, rhs: Sequence[torch.Tensor],
                  combine: str = "gather",
                  part: Optional[PartitionedB2SR] = None, op: str = "mxv",
                  lane: Optional[int] = None,
                  rhs_words: Optional[int] = None):
    """Run ``local_fn(p, *rhs_on_p)`` for every shard and combine.

    ``local_fn`` returns shard ``p``'s output rows with the block's tile
    rows as the leading axis (``psum``: a partial sum). ``gather`` returns
    the global rows ``[n_tile_rows, ...]``, ``exchange`` the owners'
    blocks ``[P * r_eq, ...]`` (the rows past ``n_tile_rows`` are zero),
    ``psum`` the sum; all on the first shard's device. ``lane`` and
    ``rhs_words`` override the comm count's output row size and operand
    elements where the port's arrays are not the reference's.
    """
    part = g.partitioned if part is None else part
    if combine in ("gather", "psum"):
        words = (sum(a.numel() for a in rhs) if rhs_words is None
                 else rhs_words)
        y = _gather(part, local_fn, rhs, combine == "psum")
        P = part.n_shards
        if combine == "psum":
            moved = (P - 1) * (words + y.numel())
        else:
            row = math.prod(y.shape[1:]) if lane is None else lane
            moved = (P - 1) * (words + P * part.rows_per_shard * row)
        _record_comm(g, part, combine, op, moved, y.element_size())
        return y
    if combine != "exchange":
        raise ValueError(f"unknown combine mode {combine!r}")
    xp: ExchangePlan = g.xplan
    if xp is None or len(rhs) != 1:
        raise ValueError("combine='exchange' needs a built ExchangePlan "
                         "and exactly one column-word operand")
    if len(g.shard_axes) != 1:
        raise ValueError("combine='exchange' runs a single-axis ring; "
                         f"shard over one mesh axis (got {g.shard_axes})")
    y = _exchange(part, xp, local_fn, rhs[0])
    rhs_lane = math.prod(rhs[0].shape[1:])
    out_lane = math.prod(y.shape[1:])
    _record_comm(g, part, "exchange", op,
                 xp.rhs_lanes * rhs_lane + xp.out_lanes * out_lane,
                 y.element_size())
    return y


def _gather(part: PartitionedB2SR, local_fn: Callable,
            rhs: Sequence[torch.Tensor], psum: bool) -> torch.Tensor:
    """The gather and psum combines. Each block's rows are copied into the
    result on the first slot as soon as they are computed, so no more
    than one block's output is held beside the result (a block that holds
    every row is the result)."""
    devs = part.devices()
    out = None
    for p in range(part.n_shards):
        if not _live(part, p):
            continue
        y = local_fn(p, *(a.to(devs[p]) for a in rhs))
        if psum:
            out = y.to(devs[0]) if out is None else out + y.to(devs[0])
            continue
        if y.shape[0] >= part.n_tile_rows:     # one block holds every row
            return y.to(devs[0])
        if out is None:
            out = y.new_empty((max(part.n_tile_rows, y.shape[0]),)
                              + y.shape[1:], device=devs[0])
        lo = part.row_starts[p]
        out[lo:lo + y.shape[0]] = y
        del y
    return out


def _exchange(part: PartitionedB2SR, xp: ExchangePlan, local_fn: Callable,
              x: torch.Tensor) -> torch.Tensor:
    """The exchange combine (see the module doc). Shard by shard: assemble
    the operand, compute, send the output rows to their owners, and free
    both, so that one shard's operand and rows are held beside the result.
    Owners on the first slot's device are written in the result itself
    (padding lanes go to one dropped row past its end); the others get
    blocks of their own, copied to the first slot at the end."""
    devs = part.devices()
    P, c_eq, r_eq = xp.n_shards, xp.c_eq, xp.r_eq
    n_x = x.shape[0]
    blocks = []
    for q in range(P):                       # shard q's equal block
        b = x[q * c_eq:(q + 1) * c_eq]
        if b.shape[0] < c_eq:                # the words past the edge: 0
            b = torch.cat([b, b.new_zeros((c_eq - b.shape[0],)
                                          + b.shape[1:])])
        blocks.append(b.to(devs[q]))
    result, owned = None, {}

    def put(p: int, name: str, i: int, rows: torch.Tensor) -> None:
        if devs[p] == devs[0]:
            # the owner's block in the result; its padding lanes (r_eq)
            # to the dropped row P * r_eq
            result.index_copy_(0, xp.index(name, i, p, devs[p], block=r_eq),
                               rows)
        else:
            if p not in owned:
                owned[p] = rows.new_zeros((r_eq + 1,) + rows.shape[1:],
                                          device=devs[p])
            owned[p].index_copy_(0, xp.index(name, i, p, devs[p]),
                                 rows.to(devs[p]))

    for p in range(P):
        if not _live(part, p):
            continue
        buf = x.new_zeros((xp.n_tc_pad + 1,) + x.shape[1:], device=devs[p])
        buf[p * c_eq:(p + 1) * c_eq] = blocks[p]
        for i, o in enumerate(xp.rhs_offsets):
            q = (p - o) % P
            # a sender's padding lanes (index c_eq) may read any word:
            # they land in the receiver's dropped slot
            send = xp.index("rhs_send_idx", i, q, devs[q], clamp=c_eq - 1)
            buf.index_copy_(0, xp.index("rhs_recv_pos", i, p, devs[p]),
                            blocks[q].index_select(0, send).to(devs[p]))
        y = local_fn(p, buf[:n_x])
        del buf
        if result is None:
            result = y.new_zeros((P * r_eq + 1,) + y.shape[1:],
                                 device=devs[0])
        if not part.block_rows(p):
            continue               # an empty block sends only padding
        last = y.shape[0] - 1
        put(p, "self_dst", 0, y.index_select(0, xp.index(
            "self_src", 0, p, devs[p], clamp=last)))
        for i, o in enumerate(xp.out_offsets):
            put((p + o) % P, "out_recv_pos", i, y.index_select(0, xp.index(
                "out_send_idx", i, p, devs[p], clamp=last)))
        del y
    for p, out in owned.items():
        result[p * r_eq:(p + 1) * r_eq] = out[:r_eq].to(devs[0])
    return result[:P * r_eq]


def _tile_rows(y: torch.Tensor, blk: ShardBlock, t: int) -> torch.Tensor:
    """A kernel's ``[block n_rows, D]`` output as ``[tile rows, t, D]``
    (the last block's partial tile row padded with zeros)."""
    want = blk.n_tile_rows * t
    if y.shape[0] != want:
        y = torch.nn.functional.pad(y, (0, 0, 0, want - y.shape[0]))
    return y.view(blk.n_tile_rows, t, y.shape[1])


# ---------------------------------------------------------------------------
# The per-shard bodies: b2sr (stacked ELL slab) and b2sr_cuda (row block)
# ---------------------------------------------------------------------------

def _slab_local(part: PartitionedB2SR, bucketed: bool, block_fn: Callable,
                fill) -> Callable:
    """The ``b2sr`` body: ``block_fn(col, tiles, x)`` over shard ``p``'s
    ELL slab, or over its harmonised bucket slabs scattered through the
    local rows (pad rows land on the garbage row ``rows_per_shard``);
    ``fill(shape, like)`` makes the empty output. A partition built
    without bucket slabs runs the ELL slab: the same results."""
    bucketed = bucketed and part.with_buckets and part.n_buckets > 0

    def local(p, x):
        col, tiles, buckets = part.slab_view(p)
        r = part.rows_per_shard
        if bucketed:
            first = block_fn(*buckets[0][:2], x)
            out = fill((r + 1,) + first.shape[1:], first)
            out[buckets[0][2]] = first
            for cb, tb, rows in buckets[1:]:
                out[rows] = block_fn(cb, tb, x)
            y = out[:r]
        else:
            y = block_fn(col, tiles, x)
        return y[:part.block_rows(p)]

    return local


def _zeros(shape, like):
    return like.new_zeros(shape)


def _items(blk: ShardBlock, budget: int, by_bits: bool = False):
    from repro_torch.kernels.items import block_items
    return block_items(blk, budget, by_bits)


# ---------------------------------------------------------------------------
# mxv rows (Table II)
# ---------------------------------------------------------------------------

def _mxv_bin_words(g, xw, call, bucketed: bool) -> torch.Tensor:
    part = g.partitioned
    if g.backend == _CUDA:
        from repro_torch.kernels.bmv.bmv import BBF_ITEM_WORK, bmv_bbb_push

        def local(p, x):
            blk = part.blocks[p]
            m = blk.b2sr
            return bmv_bbb_push(m.tile_row_ptr, m.tile_col_idx, m.bit_tiles,
                                x.contiguous(), None, t=m.tile_dim,
                                complement=True,
                                items=_items(blk, BBF_ITEM_WORK))
    else:
        local = _slab_local(part, bucketed, _bmv_bbb_block, _zeros)
    y = _sharded_call(g, local, (xw,), combine=_combine_for(g), op="mxv")
    y = y[: part.n_tile_rows]
    if call.mask is None:
        return y
    return y & (~call.mask if call.complement else call.mask)


def _mxv_bitvec_sharded(g, xw, call):
    _no_row_chunk(call)
    return _mxv_bin_words(g, xw, call, bucketed=False)


def _mxv_bitvec_bucketed_sharded(g, xw, call):
    _no_row_chunk(call)
    return _mxv_bin_words(g, xw, call, bucketed=True)


for _b, _fn in ((False, _mxv_bitvec_sharded),
                (True, _mxv_bitvec_bucketed_sharded)):
    for _backend in ("b2sr", _CUDA):
        register("mxv", "bitvec", "bin", _backend, bucketed=_b,
                 masked=BOTH, sharded=True)(_fn)


def _mxv_pull_words(g, xw, call, bucketed: bool) -> torch.Tensor:
    """The pull rows: on ``b2sr_cuda`` each shard launches the pull kernel
    with its block's slice of the mask words (its early exit reads them)
    and its block's lane occupancy; on ``b2sr`` the masked push math, as
    the unsharded pull scheme."""
    part = g.partitioned
    if g.backend != _CUDA:
        return _mxv_bin_words(g, xw, call, bucketed)
    from repro_torch.kernels.bmv.bmv import BBF_ITEM_WORK, bmv_bbb_pull
    from repro_torch.kernels.items import block_lanes

    def local(p, x):
        blk = part.blocks[p]
        m = blk.b2sr
        mask = call.mask[blk.lo:blk.hi].to(blk.device).contiguous()
        return bmv_bbb_pull(m.tile_row_ptr, m.tile_col_idx, m.bit_tiles,
                            x.contiguous(), mask, t=m.tile_dim,
                            complement=call.complement,
                            items=_items(blk, BBF_ITEM_WORK),
                            lanes=block_lanes(blk))

    y = _sharded_call(g, local, (xw,), combine=_combine_for(g), op="mxv")
    return y[: part.n_tile_rows]


def _mxv_pull_sharded(g, xw, call):
    _no_row_chunk(call)
    return _mxv_pull_words(g, xw, call, bucketed=False)


def _mxv_pull_bucketed_sharded(g, xw, call):
    _no_row_chunk(call)
    return _mxv_pull_words(g, xw, call, bucketed=True)


for _b, _fn in ((False, _mxv_pull_sharded), (True, _mxv_pull_bucketed_sharded)):
    for _backend in ("b2sr", _CUDA):
        register("mxv_pull", "bitvec", "bin", _backend, bucketed=_b,
                 masked=True, sharded=True)(_fn)


def _mxv_count_vals(g, xw, call, bucketed: bool) -> torch.Tensor:
    part = g.partitioned
    t = part.tile_dim
    dt = call.out_dtype
    if g.backend == _CUDA:
        from repro_torch.kernels.bmv.bmv import BBF_ITEM_WORK, bmv_bbf

        def local(p, x):
            blk = part.blocks[p]
            m = blk.b2sr
            return bmv_bbf(m.tile_row_ptr, m.tile_col_idx, m.bit_tiles,
                           x.contiguous(), t=t,
                           items=_items(blk, BBF_ITEM_WORK)).view(-1, t)
    else:
        local = _slab_local(part, bucketed,
                            lambda c, tl, x: _bmv_bbf_block(c, tl, x, dt),
                            _zeros)
    y = _sharded_call(g, local, (xw,), combine=_combine_for(g), op="mxv")
    y = y.reshape(-1)[: part.n_rows].to(dt)
    if call.mask is None:
        return y
    return apply_output_mask(y, call.mask, call.complement,
                             torch.zeros((), dtype=dt))


def _mxv_count_sharded(g, xw, call):
    _no_row_chunk(call)
    return _mxv_count_vals(g, xw, call, bucketed=False)


def _mxv_count_bucketed_sharded(g, xw, call):
    _no_row_chunk(call)
    return _mxv_count_vals(g, xw, call, bucketed=True)


for _b, _fn in ((False, _mxv_count_sharded),
                (True, _mxv_count_bucketed_sharded)):
    for _backend in ("b2sr", _CUDA):
        register("mxv", "bitvec", "full", _backend, bucketed=_b,
                 masked=BOTH, sharded=True)(_fn)


#: semiring name -> ``bmv_bff`` mode (the boolean semiring has no kernel
#: path, as in the unsharded ``b2sr_cuda`` row)
_MODE = {"arithmetic": "sum", "min_plus": "min_plus",
         "max_times": "max_times"}


def _mxv_dense_vals(g, x, call, bucketed: bool) -> torch.Tensor:
    part = g.partitioned
    t = part.tile_dim
    sr, av = call.semiring, call.a_value
    x3, ident, a_val = bff_setup(part.n_cols, t, x, sr, av)
    if g.backend == _CUDA:
        if sr.name not in _MODE:
            raise NotImplementedError(f"kernel path for semiring {sr.name}")
        from repro_torch.kernels.bmv.bmv import BFF_ITEM_WORK, bmv_bff

        def local(p, xr):
            blk = part.blocks[p]
            m = blk.b2sr
            return bmv_bff(m.tile_row_ptr, m.tile_col_idx, m.bit_tiles,
                           xr.contiguous(), t=t, mode=_MODE[sr.name],
                           a_value=av,
                           items=_items(blk, BFF_ITEM_WORK, by_bits=True)
                           ).view(-1, t)
    else:
        def block(c, tl, xr):
            return _bmv_bff_block(c, tl, xr, sr, a_val.to(xr.device),
                                  ident.to(xr.device), t)

        local = _slab_local(part, bucketed, block,
                            lambda shape, like: torch.full(
                                shape, ident.item(), dtype=like.dtype,
                                device=like.device))
    y = _sharded_call(g, local, (x3,), combine=_combine_for(g), op="mxv")
    y = y.reshape(-1)[: part.n_rows]
    if call.mask is None:
        return y
    return apply_output_mask(y, call.mask, call.complement,
                             sr.identity_for(y.dtype))


def _mxv_dense_sharded(g, x, call):
    _no_row_chunk(call)
    return _mxv_dense_vals(g, x, call, bucketed=False)


def _mxv_dense_bucketed_sharded(g, x, call):
    _no_row_chunk(call)
    return _mxv_dense_vals(g, x, call, bucketed=True)


for _b, _fn in ((False, _mxv_dense_sharded),
                (True, _mxv_dense_bucketed_sharded)):
    for _backend in ("b2sr", _CUDA):
        register("mxv", "dense", "full", _backend, bucketed=_b,
                 masked=BOTH, sharded=True)(_fn)


# ---------------------------------------------------------------------------
# mxm rows: dense features (SpMM), packed activations, frontier batches
# ---------------------------------------------------------------------------

def _dense_local(part: PartitionedB2SR, d: int) -> Callable:
    """The ``b2sr_cuda`` SpMM body: ``spmm_dense`` on shard ``p``'s block
    (``xr``: the operand tiles ``[n_tc, t, D]``)."""
    from repro_torch.kernels.spmm.spmm import DENSE_ITEM_WORK, spmm_dense
    t = part.tile_dim

    def local(p, xr):
        blk = part.blocks[p]
        x2 = xr.reshape(-1, d)[: part.n_cols].contiguous()
        y = spmm_dense(blk.b2sr, x2,
                       items=_items(blk, DENSE_ITEM_WORK, by_bits=True))
        return _tile_rows(y, blk, t)

    return local


def _dense_tiles(x: torch.Tensor, n_cols: int, t: int) -> torch.Tensor:
    """Dense ``[n_cols, D]`` as column tiles ``[n_tc, t, D]`` (a view when
    ``n_cols`` is a whole number of tiles; else zero padded)."""
    n_tc = ceil_div(n_cols, t)
    if x.shape[0] != n_tc * t:
        x = torch.cat([x, x.new_zeros((n_tc * t - x.shape[0], x.shape[1]))])
    return x.reshape(n_tc, t, x.shape[1])


def _dense_product(g, part: PartitionedB2SR, x: torch.Tensor,
                   combine: str) -> torch.Tensor:
    """``A · X`` over ``part`` on ``b2sr_cuda``: ``[n_rows, D]``."""
    d = x.shape[1]
    y = _sharded_call(g, _dense_local(part, d),
                      (_dense_tiles(x, part.n_cols, part.tile_dim),),
                      combine=combine, part=part, op="mxm")
    return y.reshape(-1, d)[: part.n_rows]


def _transposed_part(g) -> PartitionedB2SR:
    """Aᵀ's partition for the gradient: the graph's own, or, for a graph
    built without a transpose, ``b2sr.transpose`` of A's tiles
    partitioned over the same shards once and kept with A."""
    if g.partitioned_t is not None:
        return g.partitioned_t
    part = g.partitioned
    key = ("partitioned_t", part.row_starts, part.devices())
    cache = g.fwd.cache
    if key not in cache:
        cache[key] = partition_rows(b2sr_mod.transpose(g.b2sr),
                                    part.n_shards, with_buckets=False,
                                    devices=part.devices())
    return cache[key]


class _ShardedDense(torch.autograd.Function):
    """``Y = A · X`` per shard through ``spmm_dense``, differentiable in
    ``X``: the gradient ``Aᵀ · dY`` is the sharded dense row over Aᵀ's
    partition (:func:`_transposed_part`) with the gather combine."""

    @staticmethod
    def forward(ctx, g, x):
        ctx.g = g
        return _dense_product(g, g.partitioned, x, _combine_for(g))

    @staticmethod
    def backward(ctx, dy):
        g = ctx.g
        return None, _dense_product(g, _transposed_part(g), dy.contiguous(),
                                    "gather")


def _mxm_dense_vals(g, x, call, bucketed: bool) -> torch.Tensor:
    part = g.partitioned
    if g.backend == _CUDA:
        return _ShardedDense.apply(g, x.contiguous())
    t = part.tile_dim
    d = x.shape[1]
    local = _slab_local(part, bucketed,
                        lambda c, tl, xr: _spmm_block(c, tl, xr, t, x.dtype),
                        _zeros)
    y = _sharded_call(g, local, (_dense_tiles(x, part.n_cols, t),),
                      combine=_combine_for(g), op="mxm")
    return y.reshape(-1, d)[: part.n_rows]


def _mxm_dense_sharded(g, x, call):
    _no_row_chunk(call)
    y = _mxm_dense_vals(g, x, call, bucketed=False)
    if call.mask is None:
        return y
    return apply_output_mask(y, call.mask, call.complement,
                             call.semiring.identity_for(y.dtype))


def _mxm_dense_bucketed_sharded(g, x, call):
    _no_row_chunk(call)
    y = _mxm_dense_vals(g, x, call, bucketed=True)
    if call.mask is None:
        return y
    return apply_output_mask(y, call.mask, call.complement,
                             call.semiring.identity_for(y.dtype))


for _b, _fn in ((False, _mxm_dense_sharded),
                (True, _mxm_dense_bucketed_sharded)):
    for _backend in ("b2sr", _CUDA):
        register("mxm", "dense", "full", _backend, bucketed=_b,
                 masked=BOTH, sharded=True)(_fn)


def _mxm_bitmat_vals(g, xw, call, bucketed: bool) -> torch.Tensor:
    part = g.partitioned
    t = part.tile_dim
    d = xw.shape[1]
    dt = call.out_dtype
    if g.backend == _CUDA:
        from repro_torch.kernels.spmm.spmm import BBF_ITEM_WORK, spmm_bbf

        def local(p, xr):
            blk = part.blocks[p]
            y = spmm_bbf(blk.b2sr, xr.contiguous(), dt,
                         items=_items(blk, BBF_ITEM_WORK))
            return _tile_rows(y, blk, t)
    else:
        local = _slab_local(part, bucketed,
                            lambda c, tl, xr: _spmm_bbf_block(c, tl, xr, dt),
                            _zeros)
    y = _sharded_call(g, local, (xw,), combine=_combine_for(g), op="mxm")
    y = y.reshape(-1, d)[: part.n_rows]
    if call.mask is None:
        return y
    return apply_output_mask(y, call.mask, call.complement,
                             call.semiring.identity_for(y.dtype))


def _mxm_bitmat_sharded(g, xw, call):
    _no_row_chunk(call)
    return _mxm_bitmat_vals(g, xw, call, bucketed=False)


def _mxm_bitmat_bucketed_sharded(g, xw, call):
    _no_row_chunk(call)
    return _mxm_bitmat_vals(g, xw, call, bucketed=True)


for _b, _fn in ((False, _mxm_bitmat_sharded),
                (True, _mxm_bitmat_bucketed_sharded)):
    for _backend in ("b2sr", _CUDA):
        register("mxm", "bitmat", "full", _backend, bucketed=_b,
                 masked=BOTH, sharded=True)(_fn)


def _mxm_frontier_words(g, fw, call, bucketed: bool) -> torch.Tensor:
    part = g.partitioned
    t = part.tile_dim
    if g.backend == _CUDA:
        from repro_torch.kernels.spmm.spmm import BBB_ITEM_WORK, spmm_bbb

        def local(p, f3):
            blk = part.blocks[p]
            return spmm_bbb(blk.b2sr, f3.contiguous(), None,
                            items=_items(blk, BBB_ITEM_WORK))
    else:
        local = _slab_local(part, bucketed,
                            lambda c, tl, f3: _spmm_bbb_block(c, tl, f3, t),
                            _zeros)
    y = _sharded_call(g, local, (fw,), combine=_combine_for(g), op="mxm")
    y = y[: part.n_tile_rows]
    if call.mask is None:
        return y
    return apply_frontier_mask(y, call.mask, call.complement)


def _mxm_frontier_sharded(g, fw, call):
    _no_row_chunk(call)
    return _mxm_frontier_words(g, fw, call, bucketed=False)


def _mxm_frontier_bucketed_sharded(g, fw, call):
    _no_row_chunk(call)
    return _mxm_frontier_words(g, fw, call, bucketed=True)


for _b, _fn in ((False, _mxm_frontier_sharded),
                (True, _mxm_frontier_bucketed_sharded)):
    for _backend in ("b2sr", _CUDA):
        register("mxm", "frontier", "bin", _backend, bucketed=_b,
                 masked=BOTH, sharded=True)(_fn)
        register("mxm_pull", "frontier", "bin", _backend, bucketed=_b,
                 masked=True, sharded=True)(_fn)


# ---------------------------------------------------------------------------
# mxm rows over graph operands: A (sharded) × B (replicated), gather only
# ---------------------------------------------------------------------------

def _check_graph_dims(part: PartitionedB2SR, other) -> None:
    if part.tile_dim != other.tile_dim:
        raise ValueError(f"tile_dim mismatch: {part.tile_dim} vs "
                         f"{other.tile_dim}")
    if part.n_cols != other.n_rows:
        raise ValueError(f"inner-dim mismatch: A is {part.n_rows}x"
                         f"{part.n_cols}, B is {other.n_rows}x"
                         f"{other.n_cols}")


def _on(blk: ShardBlock, key: str, make: Callable):
    """``make(device)`` kept in the block's cache under ``key``."""
    if key not in blk.cache:
        blk.cache[key] = make(blk.device)
    return blk.cache[key]


def _b2sr_to(m: B2SR, device: torch.device) -> B2SR:
    return B2SR(tile_row_ptr=m.tile_row_ptr.to(device),
                tile_col_idx=m.tile_col_idx.to(device),
                bit_tiles=m.bit_tiles.to(device), tile_dim=m.tile_dim,
                n_rows=m.n_rows, n_cols=m.n_cols, nnz=m.nnz)


def _ell_to(e: B2SREll, device: torch.device) -> B2SREll:
    return B2SREll(tile_col_idx=e.tile_col_idx.to(device),
                   bit_tiles=e.bit_tiles.to(device),
                   row_n_tiles=e.row_n_tiles.to(device),
                   tile_dim=e.tile_dim, n_rows=e.n_rows, n_cols=e.n_cols)


def _mxm_graph_sharded(g, other, call):
    """A ∨.∧ B: each shard's SpGEMM of its row block by B (copied to its
    device), then the blocks stacked. ``b2sr_cuda``: ``spgemm_bbb`` with
    the block's rows of the mask; ``b2sr``: the packed-grid word scheme,
    the mask after the combine."""
    _no_row_chunk(call)
    part = g.partitioned
    _check_graph_dims(part, other)
    t = part.tile_dim
    n_tc_b = ceil_div(other.n_cols, t)
    words = _ell_words(other.b2sr)
    if g.backend == _CUDA:
        from repro_torch.kernels.spgemm.spgemm import spgemm_bbb
        mask = call.mask.b2sr if call.mask is not None else None
        m_ptr = None if mask is None else \
            mask.tile_row_ptr.cpu().numpy().astype("int64")

        def local(p, *_):
            blk = part.blocks[p]
            b = _b2sr_to(other.b2sr, blk.device)
            mk = None if mask is None else _row_block(
                mask, m_ptr, blk.lo, blk.hi, blk.device)
            return spgemm_bbb(blk.b2sr, b, mk, complement=call.complement)

        pieces = [local(p) for p in range(part.n_shards) if _live(part, p)]
        dev0 = part.devices()[0]
        out = stack_rows([_b2sr_to(c, dev0) for c in pieces], other.n_cols,
                         t)
        moved = (part.n_shards - 1) * (
            words + part.n_shards * part.rows_per_shard * n_tc_b * t)
        _record_comm(g, part, "gather", "mxm", moved, 4)
        return out
    b_ell = other.ell

    def local(p, *_):
        col, tiles, _b = part.slab_view(p)
        b = _ell_to(b_ell, col.device)
        return _mxm_bbb_block(col, tiles, b, t)[: part.block_rows(p)]

    grid = _sharded_call(g, local, (), op="mxm", rhs_words=words)
    m_ell = call.mask.ell if call.mask is not None else None
    grid = apply_grid_mask(grid[: part.n_tile_rows], m_ell, call.complement)
    return packed_grid_to_b2sr(grid, part.n_rows, other.n_cols)


for _backend in ("b2sr", _CUDA):
    register("mxm", "graph", "bin", _backend, bucketed=BOTH, masked=BOTH,
             sharded=True)(_mxm_graph_sharded)


def _mxm_graph_counts(g, other, call) -> torch.Tensor:
    """A +.× B: each shard's count grid of its rows by B (the word scheme
    the unsharded rows of both backends run), then the blocks stacked:
    dense int32 ``[n_rows, n_cols]``."""
    part = g.partitioned
    _check_graph_dims(part, other)
    t = part.tile_dim
    b_ell = other.ell
    n_tc_b = ceil_div(other.n_cols, t)

    def local(p, *_):
        blk = part.blocks[p]
        if g.backend == _CUDA:
            a_ell = _on(blk, "ell", lambda dev: to_ell(blk.b2sr))
            col, tiles = a_ell.tile_col_idx, a_ell.bit_tiles
        else:
            col, tiles, _b = part.slab_view(p)
        grid = _mxm_bbf_block(col, tiles, _ell_to(b_ell, col.device), t)
        return grid[: part.block_rows(p)]

    grid = _sharded_call(g, local, (), op="mxm", lane=n_tc_b * t * t,
                         rhs_words=_ell_words(other.b2sr))
    counts = _count_grid_to_dense(grid[: part.n_tile_rows], part.n_rows,
                                  other.n_cols, torch.int32)
    if call.mask is None:
        return counts
    return _apply_dense_mask(counts, call.mask.ell, call.complement)


def _mxm_graph_count_sharded(g, other, call):
    _no_row_chunk(call)
    return _mxm_graph_counts(g, other, call)


for _backend in ("b2sr", _CUDA):
    register("mxm", "graph", "full", _backend, bucketed=BOTH, masked=BOTH,
             sharded=True)(_mxm_graph_count_sharded)


# ---------------------------------------------------------------------------
# mxm_sum: Σ L ⊙ (L·Lᵀ), per-shard partials and one psum
# ---------------------------------------------------------------------------

def _tri_sum_sharded(g, tri, call):
    """Per-shard masked count partials of L's row blocks, added in shard
    order (int64). ``b2sr_cuda``: ``bmm_tc`` with A = mask = the block of
    L and Bᵀ = L (on the block's device), its plan kept with the block;
    ``b2sr``: the count grid of the block's slab by Lᵀ, masked by the
    slab's own tiles."""
    _no_row_chunk(call)
    part = tri.partitioned(g.partitioned.n_shards, g.partitioned.devices())
    lower = tri.b2sr
    t = part.tile_dim
    if "lt_words" not in tri.cache:     # Lᵀ's ELL, as the reference counts
        n_tc = ceil_div(lower.n_cols, t)
        k = torch.bincount(lower.tile_col_idx.long(), minlength=n_tc)
        tri.cache["lt_words"] = n_tc * (
            max(int(k.max()) if k.numel() else 1, 1) * (1 + t) + 1)
    if g.backend == _CUDA:
        from repro_torch.kernels.bmm.bmm import bmm_tc, tc_plan

        def local(p, *_):
            blk = part.blocks[p]
            a = blk.b2sr
            bt = _on(blk, "lower", lambda dev: _b2sr_to(lower, dev))
            if a.device.type != "cuda":     # the plain version needs no plan
                return bmm_tc(a, bt, a)
            plan = _on(blk, "bmm_tc_plan", lambda dev: tc_plan(a, bt, a))
            return bmm_tc(a, bt, a, plan=plan)
    else:
        ell_t = tri.ell_t

        def local(p, *_):
            col, tiles, _b = part.slab_view(p)
            counts = _mxm_bbf_block(col, tiles, _ell_to(ell_t, col.device),
                                    t)                        # [R, C, t, t]
            mg = ell_to_packed_grid(B2SREll(
                tile_col_idx=col, bit_tiles=tiles,
                row_n_tiles=(col >= 0).sum(1).to(torch.int32),
                tile_dim=t, n_rows=col.shape[0] * t, n_cols=part.n_cols))
            m_bits = unpack_bits(mg, t)                       # [R, C, t, t]
            return torch.where(m_bits, counts, 0).sum(dtype=torch.int64)

    return _sharded_call(g, local, (), combine="psum", part=part,
                         op="mxm_sum", rhs_words=tri.cache["lt_words"])


for _backend in ("b2sr", _CUDA):
    register("mxm_sum", "tri", "full", _backend, bucketed=BOTH, masked=True,
             sharded=True)(_tri_sum_sharded)

del _b, _fn, _backend


# ---------------------------------------------------------------------------
# Call-time sharded SpMM (the reference's ambient-mesh entry point)
# ---------------------------------------------------------------------------

def spmm_b2sr_shardmap(graph, x: torch.Tensor, axes: Sequence[str],
                       mesh=None) -> torch.Tensor:
    """``A · x`` row-partitioned over ``mesh`` at call time, the port of
    the reference's ``spmm_b2sr_shardmap``.

    ``graph`` (a ``GraphMatrix``, or a ``B2SR`` wrapped on ``b2sr_cuda``)
    is split into equal blocks of tile rows over the mesh axes among
    ``axes`` and the product runs through the sharded dense ``mxm`` row
    (on ``b2sr_cuda``: ``spmm_dense`` per shard, gather combine), the
    result on the first slot. ``mesh`` defaults to every visible CUDA
    device on the first axis. Where the reference's even-block contract
    fails (no axis on the mesh; the tile rows or ``x``'s rows not a
    multiple of the slot count; ``n_rows`` not a whole number of tiles)
    it runs the unsharded row, as the reference does.
    """
    from repro_torch.core.graphblas import GraphMatrix
    from repro_torch.core.mesh import make_mesh
    from repro_torch.core.partition import shard_count
    g = (graph if isinstance(graph, GraphMatrix)
         else GraphMatrix.from_b2sr(graph, with_transpose=False,
                                    backend=_CUDA))
    if g.sharded:
        g = g.unshard()
    want = tuple(axes)
    if mesh is None and want:
        mesh = make_mesh((-1,) + (1,) * (len(want) - 1), want)
    axes = tuple(a for a in want if mesh is not None
                 and a in mesh.axis_names)
    if not axes:
        return g.mxm(x)
    p_total = shard_count(mesh, axes)
    t = g.tile_dim
    n_tr = ceil_div(g.n_rows, t)
    if (n_tr % p_total or x.shape[0] % p_total
            or g.n_rows != n_tr * t):
        return g.mxm(x)
    return g.shard(mesh, axes, balanced=False).mxm(x)
