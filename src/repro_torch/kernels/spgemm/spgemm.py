"""Launcher for the boolean B2SR SpGEMM in ``spgemm.cu``.

  spgemm_bbb  replaces ``repro.kernels.spgemm.spgemm.mxm_bin_bin_bin_pallas``

``spgemm_bbb(a, b, mask, complement=)`` is C⟨M⟩ (or C⟨¬M⟩) = A ∨.∧ B as
a B2SR: two launches (count, fill), then torch drops the tiles that came
out zero, the reference's ``packed_grid_to_b2sr`` step on a sparse list.
A CUDA tensor goes to the kernel (a build or launch failure raises); a
CPU tensor to the plain version in ``ref.py``. ``spgemm_bbb.launches``
counts the calls that launched it.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional

import torch

from repro_torch.core.b2sr import B2SR, ceil_div, count_bits
from repro_torch.kernels import common
from repro_torch.kernels.spgemm import ref

SOURCE = Path(__file__).with_name("spgemm.cu")
_PTR, _INT = ctypes.c_void_p, ctypes.c_int
_ARGS = [_PTR] * 9 + [_INT] + [_PTR] * 4 + [_INT] * 4 + [_PTR] * 2
_MASK_MODE = {None: 0, False: 1, True: 2}


def spgemm_bbb(a: B2SR, b: B2SR, mask: Optional[B2SR] = None, *,
               complement: bool = False) -> B2SR:
    """Boolean SpGEMM of B2SR ``a`` [R x K] and ``b`` [K x C], masked by
    ``mask`` [R x C] (its complement with ``complement=True``) before the
    store. The mask's tile-rows must be sorted by column. Returns C with
    sorted tile-rows and no all-zero tile; ``nnz`` counts its bits."""
    t = a.tile_dim
    if a.n_cols != b.n_rows:
        raise ValueError(f"inner-dim mismatch: A is {a.n_rows}x{a.n_cols}, "
                         f"B is {b.n_rows}x{b.n_cols}")
    if mask is not None and (mask.n_rows, mask.n_cols) != (a.n_rows,
                                                           b.n_cols):
        raise ValueError(f"mask is {mask.n_rows}x{mask.n_cols}, the product "
                         f"{a.n_rows}x{b.n_cols}")
    dev = a.device
    for name, m in (("a", a), ("b", b), ("mask", mask)):
        if m is not None:
            common.check_b2sr(name, m, dev, t)
    if dev.type != "cuda":
        return ref.spgemm_bbb(a, b, mask, complement=complement)
    common.check_bitmap_width(b.n_tile_cols, "B")
    n_tr = a.n_tile_rows
    counts = torch.zeros(n_tr, dtype=torch.int64, device=dev)
    counter = torch.zeros(2, dtype=torch.int32, device=dev)
    m_ptrs = ((None,) * 3 if mask is None else
              (mask.tile_row_ptr.data_ptr(), mask.tile_col_idx.data_ptr(),
               mask.bit_tiles.data_ptr()))
    mode = _MASK_MODE[None if mask is None else bool(complement)]

    def launch(fill, row_off, out_col, out_mask, out_tiles, ctr):
        common.call(SOURCE, "spgemm_bbb", _ARGS, a.bit_tiles,
                    *(p.data_ptr() for m in (a, b)
                      for p in (m.tile_row_ptr, m.tile_col_idx,
                                m.bit_tiles)),
                    *m_ptrs, mode, row_off, out_col, out_mask, out_tiles,
                    n_tr, ceil_div(b.n_tile_cols, 32), t, fill, ctr)

    if n_tr:
        launch(0, counts.data_ptr(), None, None, None, counter.data_ptr())
    offsets = torch.zeros(n_tr + 1, dtype=torch.int64, device=dev)
    offsets[1:] = torch.cumsum(counts, 0)
    total = int(offsets[-1])
    out_col = torch.empty(total, dtype=torch.int32, device=dev)
    out_tiles = torch.zeros((total, t), dtype=torch.int32, device=dev)
    out_mask = torch.empty(total if mask is not None else 0,
                           dtype=torch.int32, device=dev)
    if total:
        launch(1, offsets.data_ptr(), out_col.data_ptr(),
               out_mask.data_ptr() if mask is not None else None,
               out_tiles.data_ptr(), counter.data_ptr() + 4)
    if n_tr:
        spgemm_bbb.launches += 1
    keep = (out_tiles != 0).any(1)
    rows = torch.repeat_interleave(torch.arange(n_tr, device=dev), counts)
    ptr = torch.zeros(n_tr + 1, dtype=torch.int64, device=dev)
    ptr[1:] = torch.cumsum(torch.bincount(rows[keep], minlength=n_tr), 0)
    tiles = out_tiles[keep]
    return B2SR(tile_row_ptr=ptr.to(torch.int32), tile_col_idx=out_col[keep],
                bit_tiles=tiles, tile_dim=t, n_rows=a.n_rows,
                n_cols=b.n_cols, nnz=count_bits(tiles))


spgemm_bbb.launches = 0
