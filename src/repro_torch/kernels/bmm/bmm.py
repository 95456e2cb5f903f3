"""Launcher for the masked B2SR product reduction in ``bmm.cu``.

  bmm_tc  replaces ``repro.kernels.bmm.bmm.bmm_bin_bin_sum_masked_pallas``

``bmm_tc(a, bt, mask)`` is Σ mask ⊙ (A·B) with B given as Bᵀ's B2SR, an
exact int64 scalar; ``tri_count`` passes L three times. A CUDA tensor
goes to the kernel (a build or launch failure raises); a CPU tensor to the
plain version in ``ref.py``. ``bmm_tc.launches`` counts the kernel's
launches: one or two a call, for the kept and the moved tiles of its
:class:`TcPlan`.
"""

from __future__ import annotations

import ctypes
import dataclasses
from pathlib import Path
from typing import Optional, Tuple

import torch

from repro_torch.core.b2sr import B2SR, ceil_div, tile_rows
from repro_torch.kernels import common
from repro_torch.kernels.bmm import ref

SOURCE = Path(__file__).with_name("bmm.cu")
_PTR, _INT, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
_ARGS = [_PTR] * 11 + [_I64] * 2 + [_INT] + [_PTR] * 3 + [_INT] * 5 + \
    [_PTR] * 2
#: probes (tiles of Bᵀ's rows walked) a work item holds: a tile-row is cut
#: into runs of its mask tiles of about this much work, and at least 4
#: times its A row's length (the block's set-up), so that a hub row (11 M
#: probes at R-MAT scale 21) spreads over many blocks. On an H100 at R-MAT
#: scale 21 (``tools/tc_variants.py``): 2^15 took 87.4 ms, 2^16 80.5 and
#: 2^17 83.0 (a block waits for its slowest warp at the end of an item)
ITEM_PROBES = 1 << 16


def _row_lengths(m: B2SR) -> torch.Tensor:
    return (m.tile_row_ptr[1:] - m.tile_row_ptr[:-1]).long()


def _work_items(a: B2SR, bt: B2SR, mask, probes: int = ITEM_PROBES):
    """(item_row, item_begin): runs of the mask's tiles (a B2SR or a
    :class:`TcPart`) within one tile-row, each of about ``probes`` probes
    (int32)."""
    rows = tile_rows(mask)
    ptr = mask.tile_row_ptr.long()
    bt_len, a_len = _row_lengths(bt), _row_lengths(a)
    work = bt_len[mask.tile_col_idx.long()] + 1
    done = torch.cumsum(work, 0) - work                 # before each tile
    part = (done - done[ptr[rows]]) // (4 * a_len[rows]).clamp(min=probes)
    first = torch.ones_like(rows, dtype=torch.bool)
    first[1:] = (rows[1:] != rows[:-1]) | (part[1:] != part[:-1])
    begin = torch.nonzero(first).flatten()
    item_begin = torch.cat([begin, begin.new_tensor([mask.n_tiles])])
    return rows[begin].to(torch.int32), item_begin.to(torch.int32)


def min_walk(a: B2SR, bt: B2SR, mask: B2SR) -> int:
    """Σ over the mask's tiles (I, J) of min(len(A row I), len(Bᵀ row
    J)): the tiles a merge of the two sorted rows reads at the least to
    find their common tiles (the bound's count of that search)."""
    return int(torch.minimum(_row_lengths(a)[tile_rows(mask)],
                             _row_lengths(bt)[mask.tile_col_idx.long()]).sum())


@dataclasses.dataclass(frozen=True)
class TcPart:
    """The mask tiles of one launch, in CSR over the tile-rows of the
    bitmap's operand: tile k lies in column ``tile_col_idx[k]`` and its
    words are tile ``idx[k]`` of the mask, read transposed when
    ``moved`` (the tiles (J, I) of a launch with A and Bᵀ swapped)."""

    tile_row_ptr: torch.Tensor   # int32[n_tile_rows + 1]
    tile_col_idx: torch.Tensor   # int32[n_tiles]
    idx: torch.Tensor            # int32[n_tiles]
    n_rows: int
    tile_dim: int
    moved: bool

    @property
    def n_tile_rows(self) -> int:
        return ceil_div(self.n_rows, self.tile_dim)

    @property
    def n_tiles(self) -> int:
        return int(self.idx.shape[0])

    @property
    def device(self) -> torch.device:
        return self.idx.device


def _part(rows: torch.Tensor, cols: torch.Tensor, idx: torch.Tensor,
          n_rows: int, t: int, moved: bool) -> TcPart:
    """:class:`TcPart` of tiles at (``rows``, ``cols``), sorted by row."""
    n_tr = ceil_div(n_rows, t)
    ptr = torch.zeros(n_tr + 1, dtype=torch.int64, device=idx.device)
    ptr[1:] = torch.cumsum(torch.bincount(rows, minlength=n_tr), 0)
    return TcPart(ptr.to(torch.int32), cols.to(torch.int32),
                  idx.to(torch.int32), n_rows, t, moved)


@dataclasses.dataclass(frozen=True)
class TcPlan:
    """The launches of one ``bmm_tc`` call. ``kept``: the mask tiles
    (I, J) walked along Bᵀ's row J against a bitmap of A's row I;
    ``moved``: the tiles (J, I) walked along A's row I against a bitmap of
    Bᵀ's row J (a second launch with the operands swapped): each mask
    tile goes to the side whose walk is the shorter of its two rows. Each
    part has its work items (:func:`_work_items`: rows, and bounds into
    the part's tiles). The plan holds int32 indices only, no tiles."""

    kept: TcPart
    kept_items: Tuple[torch.Tensor, torch.Tensor]
    moved: Optional[TcPart] = None
    moved_items: Optional[Tuple[torch.Tensor, torch.Tensor]] = None


def tc_plan(a: B2SR, bt: B2SR, mask: B2SR, probes: int = ITEM_PROBES,
            shorter: bool = True) -> TcPlan:
    """The :class:`TcPlan` of ``bmm_tc(a, bt, mask)``: with ``shorter``,
    mask tiles (I, J) whose A row is shorter than Bᵀ's row J are moved,
    so the kernel probes Σ min(len(A row I), len(Bᵀ row J)) tiles in all
    (:func:`min_walk`); else every Bᵀ row is walked. Items of about
    ``probes`` probes (:func:`_work_items`)."""
    t = mask.tile_dim
    rows = tile_rows(mask)
    cols = mask.tile_col_idx.long()
    swap = (_row_lengths(a)[rows] < _row_lengths(bt)[cols]) if shorter \
        else torch.zeros_like(rows, dtype=torch.bool)
    keep = torch.nonzero(~swap).flatten()
    kept = _part(rows[keep], cols[keep], keep, mask.n_rows, t, False)
    plan = TcPlan(kept, _work_items(a, bt, kept, probes))
    if not bool(swap.any()):
        return plan
    swapped = torch.nonzero(swap).flatten()
    r2, c2 = rows[swapped], cols[swapped]
    order = torch.argsort(c2 * mask.n_tile_rows + r2)
    moved = _part(c2[order], r2[order], swapped[order], mask.n_cols, t,
                  True)
    return dataclasses.replace(plan, moved=moved,
                               moved_items=_work_items(bt, a, moved, probes))


def bmm_tc(a: B2SR, bt: B2SR, mask: B2SR, *, with_work: bool = False,
           plan: Optional[TcPlan] = None):
    """Σ mask ⊙ (A·B) for B2SR ``a`` [R x K], ``bt`` = Bᵀ [C x K] and
    ``mask`` [R x C]: an int64 scalar tensor on their device.

    A's and Bᵀ's tile-rows must be sorted by column (``coo_to_b2sr`` and
    every SpGEMM output are). ``with_work=True`` also returns the number
    of (mask bit, common tile) pairs the kernel worked through (CUDA
    only). ``plan``: :func:`tc_plan` of the same operands, kept by a
    caller that counts again (the ``b2sr_cuda`` triangle row keeps it
    with L); built here when None.
    """
    got = _bmm_tc(a, bt, mask, with_work, True, plan)
    return got[:2] if with_work else got


def _bmm_tc(a: B2SR, bt: B2SR, mask: B2SR, with_work: bool, count: bool,
            plan: Optional[TcPlan]):
    """:func:`bmm_tc` for tests and measurements: ``count=False`` runs
    the kernel's probes alone (the total is 0). ``with_work=True``
    returns (total, work, the entries queued for the count stage)."""
    t = a.tile_dim
    if a.n_cols != bt.n_cols:
        raise ValueError(f"inner-dim mismatch: A is {a.n_rows}x{a.n_cols}, "
                         f"Bᵀ is {bt.n_rows}x{bt.n_cols}")
    if (mask.n_rows, mask.n_cols) != (a.n_rows, bt.n_rows):
        raise ValueError(f"mask is {mask.n_rows}x{mask.n_cols}, the product "
                         f"{a.n_rows}x{bt.n_rows}")
    dev = a.device
    for name, m in (("a", a), ("bt", bt), ("mask", mask)):
        common.check_b2sr(name, m, dev, t)
    if dev.type != "cuda":
        if with_work:
            raise ValueError("the work count comes from the kernel; "
                             "with_work needs CUDA tensors")
        return ref.bmm_tc(a, bt, mask)
    for name, m in (("a", a), ("bt", bt)):
        if m.bit_tiles.numel() and m.bit_tiles.data_ptr() % 16:
            raise ValueError(f"{name}.bit_tiles must be 16-byte aligned "
                             f"(vector loads)")
    out = torch.zeros(3, dtype=torch.int64, device=dev)
    counters = torch.zeros(2, dtype=torch.int32, device=dev)
    # scratch: each tile's row occupancy word, filled by the first launch
    # that runs
    a_occ = torch.empty(a.n_tiles, dtype=torch.int32, device=dev)
    same = (bt.bit_tiles.data_ptr() == a.bit_tiles.data_ptr()
            and bt.n_tiles == a.n_tiles)
    bt_occ = a_occ if same else torch.empty(bt.n_tiles, dtype=torch.int32,
                                            device=dev)
    if mask.n_tiles:
        if plan is None:
            plan = tc_plan(a, bt, mask)
        launches = [(a, bt, a_occ, bt_occ, plan.kept, plan.kept_items)]
        if plan.moved is not None:
            launches.append((bt, a, bt_occ, a_occ, plan.moved,
                             plan.moved_items))
        filled = False
        for i, (x, y, x_occ, y_occ, part, (item_row, item_begin)) in \
                enumerate(launches):
            if not part.n_tiles:
                continue
            common.call(SOURCE, "bmm_tc", _ARGS, out,
                        *(p.data_ptr() for m in (x, y)
                          for p in (m.tile_row_ptr, m.tile_col_idx,
                                    m.bit_tiles)),
                        part.tile_col_idx.data_ptr(), part.idx.data_ptr(),
                        mask.bit_tiles.data_ptr(), x_occ.data_ptr(),
                        y_occ.data_ptr(), x.n_tiles, y.n_tiles, int(filled),
                        item_row.data_ptr(), item_begin.data_ptr(),
                        out.data_ptr(), item_row.numel(),
                        ceil_div(a.n_tile_cols, 32), int(count),
                        int(part.moved), t, counters[i].data_ptr())
            filled = True
            bmm_tc.launches += 1
    return (out[0], out[1], out[2]) if with_work else out[0]


bmm_tc.launches = 0
