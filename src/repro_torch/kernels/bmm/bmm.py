"""Launcher for the masked B2SR product reduction in ``bmm.cu``.

  bmm_tc  replaces ``repro.kernels.bmm.bmm.bmm_bin_bin_sum_masked_pallas``

``bmm_tc(a, bt, mask)`` is Σ mask ⊙ (A·B) with B given as Bᵀ's B2SR, an
exact int64 scalar; ``tri_count`` passes L three times. A CUDA tensor
goes to the kernel (a build or launch failure raises); a CPU tensor to the
plain version in ``ref.py``. ``bmm_tc.launches`` counts the launches.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.core.b2sr import B2SR, ceil_div, tile_rows
from repro_torch.kernels import common
from repro_torch.kernels.bmm import ref

SOURCE = Path(__file__).with_name("bmm.cu")
_PTR, _INT, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
_ARGS = [_PTR] * 10 + [_I64] * 2 + [_PTR] * 3 + [_INT] * 3 + [_PTR] * 2
#: probes (tiles of Bᵀ's rows walked) a work item holds: a tile-row is cut
#: into runs of its mask tiles of about this much work, and at least 4
#: times its A row's length (the block's set-up), so that a hub row (11 M
#: probes at R-MAT scale 21) spreads over many blocks
ITEM_PROBES = 1 << 15


def _work_items(a: B2SR, bt: B2SR, mask: B2SR):
    """(item_row, item_begin): runs of the mask's tiles within one
    tile-row, each of about ``ITEM_PROBES`` probes (int32)."""
    rows = tile_rows(mask)
    ptr = mask.tile_row_ptr.long()
    bt_len = (bt.tile_row_ptr[1:] - bt.tile_row_ptr[:-1]).long()
    a_len = (a.tile_row_ptr[1:] - a.tile_row_ptr[:-1]).long()
    work = bt_len[mask.tile_col_idx.long()] + 1
    done = torch.cumsum(work, 0) - work                 # before each tile
    part = (done - done[ptr[rows]]) // (4 * a_len[rows]).clamp(
        min=ITEM_PROBES)
    first = torch.ones_like(rows, dtype=torch.bool)
    first[1:] = (rows[1:] != rows[:-1]) | (part[1:] != part[:-1])
    begin = torch.nonzero(first).flatten()
    item_begin = torch.cat([begin, begin.new_tensor([mask.n_tiles])])
    return rows[begin].to(torch.int32), item_begin.to(torch.int32)


def bmm_tc(a: B2SR, bt: B2SR, mask: B2SR, *, with_work: bool = False):
    """Σ mask ⊙ (A·B) for B2SR ``a`` [R x K], ``bt`` = Bᵀ [C x K] and
    ``mask`` [R x C]: an int64 scalar tensor on their device.

    A's tile-rows must be sorted by column (``coo_to_b2sr`` and every
    SpGEMM output are). ``with_work=True`` also returns the number of
    (mask bit, common tile) pairs the kernel worked through (CUDA only).
    """
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
    common.check_bitmap_width(a.n_tile_cols, "A")
    for name, m in (("a", a), ("bt", bt)):
        if m.bit_tiles.numel() and m.bit_tiles.data_ptr() % 16:
            raise ValueError(f"{name}.bit_tiles must be 16-byte aligned "
                             f"(vector loads)")
    out = torch.zeros(2, dtype=torch.int64, device=dev)
    counter = torch.zeros(1, dtype=torch.int32, device=dev)
    # scratch: each tile's row occupancy word, filled by the first launch
    a_occ = torch.empty(a.n_tiles, dtype=torch.int32, device=dev)
    same = (bt.bit_tiles.data_ptr() == a.bit_tiles.data_ptr()
            and bt.n_tiles == a.n_tiles)
    bt_occ = a_occ if same else torch.empty(bt.n_tiles, dtype=torch.int32,
                                            device=dev)
    if mask.n_tiles:
        item_row, item_begin = _work_items(a, bt, mask)
        common.call(SOURCE, "bmm_tc", _ARGS, out,
                    *(p.data_ptr() for m in (a, bt)
                      for p in (m.tile_row_ptr, m.tile_col_idx, m.bit_tiles)),
                    mask.tile_col_idx.data_ptr(), mask.bit_tiles.data_ptr(),
                    a_occ.data_ptr(), bt_occ.data_ptr(), a.n_tiles,
                    bt.n_tiles, item_row.data_ptr(), item_begin.data_ptr(),
                    out.data_ptr(), item_row.numel(),
                    ceil_div(a.n_tile_cols, 32), t, counter.data_ptr())
        bmm_tc.launches += 1
    return (out[0], out[1]) if with_work else out[0]


bmm_tc.launches = 0
