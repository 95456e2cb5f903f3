"""Launchers for the B2SR mxv CUDA kernels in ``bmv.cu``.

  bmv_bbb_push  replaces ``repro.kernels.bmv.bmv.bmv_bin_bin_bin_pallas``
  bmv_bbb_pull  replaces ``bmv_bin_bin_bin_pull_pallas``
  bmv_bff       replaces ``bmv_bin_full_full_pallas`` (semiring mxv)
  bmv_bbf       replaces ``bmv_bin_bin_full_pallas`` (count mxv)

All take the B2SR CSR-over-tiles arrays as they are (no ELL padding) and
cut each tile-row into work items (``kernels/items.py``), runs of its
tiles that a warp takes each, so a hub tile-row spreads over many warps;
a caller may pass the items it keeps for the matrix (the ``b2sr_cuda``
rows do; push, pull and ``bmv_bbf`` share one cut). Any cut gives the
same result (the sum mode of ``bmv_bff`` up to float32 rounding).

A CUDA tensor goes to the kernel: a build or launch failure raises. A
CPU tensor goes to the plain version in ``ref.py``. Each wrapper counts
its launches in its ``launches`` attribute, so a run can show that it
went through the kernel.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional

import torch

from repro_torch.core.words import WORD
from repro_torch.kernels import common
from repro_torch.kernels.bmv import ref
from repro_torch.kernels.items import (WorkItems, check_items, cut_rows,
                                      row_lanes)

SOURCE = Path(__file__).with_name("bmv.cu")
_PTR, _INT, _FLOAT = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_PUSH_ARGS = [_PTR] * 5 + [_INT] + [_PTR] * 3 + [_INT] * 2 + [_PTR]
_PULL_ARGS = [_PTR] * 5 + [_INT] + [_PTR] * 4 + [_INT] * 2 + [_PTR]
_BFF_ARGS = [_PTR] * 5 + [_INT] + [_PTR] * 3 + [_INT] + [_PTR] * 3 + \
    [_INT] * 2 + [_FLOAT] * 2 + [_PTR]
_BBF_ARGS = [_PTR] * 5 + [_INT] + [_PTR] * 2 + [_INT] + [_PTR]
#: work of a ``bmv_bff`` item, in set bits plus one per tile (a lane
#: gathers an entry of x per set bit of its word); equal to
#: ``spmm.DENSE_ITEM_WORK``, so the two kernels share one cut
BFF_ITEM_WORK = 2048
#: work of a ``bmv_bbf``, a ``bmv_bbb_push`` and a ``bmv_bbb_pull`` item,
#: in tiles (a warp reads 32 column indices and x words at a time,
#: whatever the tiles' bits); equal to ``spmm.BBF_ITEM_WORK``, so the
#: kernels share one cut
BBF_ITEM_WORK = 256
#: ``mode`` argument of the ``bmv_bff`` kernel
BFF_MODE_IDS = {"sum": 0, "min_plus": 1, "max_times": 2}


def _check(tile_row_ptr, tile_col_idx, bit_tiles, x, mask, t: int,
           x_dtype: torch.dtype = WORD) -> None:
    """Validate what the kernels take: devices, dtypes, shapes, layout.

    ``x`` is packed words (int32[C]) or, with ``x_dtype=torch.float32``,
    the dense tiles ``x3`` float32[C, t].
    """
    named = {"tile_row_ptr": tile_row_ptr, "tile_col_idx": tile_col_idx,
             "bit_tiles": bit_tiles, "x": x}
    if mask is not None:
        named["mask"] = mask
    for name, a in named.items():
        if a.device != x.device:
            raise ValueError(f"{name} is on {a.device}, x on {x.device}")
        want = x_dtype if name == "x" else WORD
        if a.dtype != want:
            raise TypeError(f"{name} must be {want}, got {a.dtype}")
        if not a.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    n_rows = tile_row_ptr.shape[0] - 1
    if t not in (4, 8, 16, 32):
        raise ValueError(f"tile dim must be 4, 8, 16 or 32, got {t}")
    if bit_tiles.dim() != 2 or bit_tiles.shape != (tile_col_idx.shape[0], t):
        raise ValueError(f"bit_tiles shape {tuple(bit_tiles.shape)} != "
                         f"({tile_col_idx.shape[0]}, {t})")
    if x_dtype != WORD and (x.dim() != 2 or x.shape[1] != t):
        raise ValueError(f"x3 shape {tuple(x.shape)} is not [C, {t}]")
    if mask is not None and mask.shape != (n_rows,):
        raise ValueError(f"mask shape {tuple(mask.shape)} != ({n_rows},)")
    if bit_tiles.numel() and bit_tiles.data_ptr() % 16:
        raise ValueError("bit_tiles must be 16-byte aligned (vector loads)")


def _bbb_step(kernel, argtypes, tile_row_ptr, tile_col_idx, bit_tiles, x,
              mask, t: int, complement: bool, items: Optional[WorkItems],
              *lanes) -> torch.Tensor:
    """Launch push's or pull's kernel (one walk, two cadences) on CUDA
    tensors: int32[R] packed words, zero where nothing lands. ``lanes``:
    pull's lane occupancy pointer (push takes none)."""
    _check(tile_row_ptr, tile_col_idx, bit_tiles, x, mask, t)
    n_rows = tile_row_ptr.shape[0] - 1
    out = torch.zeros(n_rows, dtype=WORD, device=x.device)
    if items is None:
        items = cut_rows(tile_row_ptr, bit_tiles, BBF_ITEM_WORK)
    check_items(items, x.device)
    if items.n_items:
        common.call(SOURCE, kernel.__name__, argtypes, x,
                    tile_col_idx.data_ptr(), bit_tiles.data_ptr(),
                    items.row.data_ptr(), items.begin.data_ptr(),
                    items.slot.data_ptr(), items.n_items, x.data_ptr(),
                    None if mask is None else mask.data_ptr(), *lanes,
                    out.data_ptr(), t, int(complement))
        kernel.launches += 1
    return out


def bmv_bbb_push(tile_row_ptr: torch.Tensor, tile_col_idx: torch.Tensor,
                 bit_tiles: torch.Tensor, x: torch.Tensor,
                 mask: Optional[torch.Tensor], *, t: int,
                 complement: bool = True,
                 items: Optional[WorkItems] = None) -> torch.Tensor:
    """Push BFS step: ``y = OR_k hits(tile, x[col]) & (~mask | mask)``.

    ``mask=None`` keeps every lane. Returns int32[R] packed words.
    ``items`` (default: cut by tiles, :data:`BBF_ITEM_WORK`) must be a cut
    of these arrays.
    """
    if not x.is_cuda:
        return ref.bmv_bbb_push(tile_row_ptr, tile_col_idx, bit_tiles, x,
                                mask, t=t, complement=complement)
    return _bbb_step(bmv_bbb_push, _PUSH_ARGS, tile_row_ptr, tile_col_idx,
                     bit_tiles, x, mask, t, complement, items)


def bmv_bbb_pull(tile_row_ptr: torch.Tensor, tile_col_idx: torch.Tensor,
                 bit_tiles: torch.Tensor, x: torch.Tensor, mask: torch.Tensor,
                 *, t: int, complement: bool = True,
                 items: Optional[WorkItems] = None,
                 lanes: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Pull BFS step: push's function under a mask, with push's walk and
    an exit test after every batch of 32 tiles; bit-exact with push.

    ``items`` (default: cut by tiles, :data:`BBF_ITEM_WORK`) must be a cut
    of these arrays, and ``lanes`` (default: computed here) their
    :func:`~repro_torch.kernels.items.row_lanes` or a superset of it: a
    row stops once the allowed lanes among them are set.
    """
    if mask is None:
        raise ValueError("the pull step needs a mask (nothing to exit on)")
    if not x.is_cuda:
        return ref.bmv_bbb_pull(tile_row_ptr, tile_col_idx, bit_tiles, x,
                                mask, t=t, complement=complement)
    if lanes is None:
        lanes = row_lanes(tile_row_ptr, bit_tiles)
    if (lanes.device != x.device or lanes.dtype != WORD
            or lanes.shape != mask.shape or not lanes.is_contiguous()):
        raise ValueError(f"lanes must be contiguous int32{tuple(mask.shape)}"
                         f" on {x.device}, got {lanes.dtype}"
                         f"{tuple(lanes.shape)} on {lanes.device}")
    return _bbb_step(bmv_bbb_pull, _PULL_ARGS, tile_row_ptr, tile_col_idx,
                     bit_tiles, x, mask, t, complement, items,
                     lanes.data_ptr())


def bmv_bff(tile_row_ptr: torch.Tensor, tile_col_idx: torch.Tensor,
            bit_tiles: torch.Tensor, x3: torch.Tensor, *, t: int, mode: str,
            a_value: float = 1.0,
            items: Optional[WorkItems] = None) -> torch.Tensor:
    """Semiring mxv over the dense tiles ``x3`` [C, t]: float32[R * t].

    ``y[i] = ⊕_j (A_ij ? a_value ⊗ x_j : ⊕-identity)`` with ``mode`` one of
    ``sum`` (arithmetic), ``min_plus``, ``max_times``; rows without a set
    bit hold the identity. The kernel takes float32 only. ``items``
    (default: cut by set bits, :data:`BFF_ITEM_WORK`) must be a cut of
    these arrays.
    """
    if mode not in BFF_MODE_IDS:
        raise ValueError(f"mode must be one of {tuple(BFF_MODE_IDS)}, "
                         f"got {mode!r}")
    if not x3.is_cuda:
        return ref.bmv_bff(tile_row_ptr, tile_col_idx, bit_tiles, x3, t=t,
                           mode=mode, a_value=a_value)
    _check(tile_row_ptr, tile_col_idx, bit_tiles, x3, None, t,
           x_dtype=torch.float32)
    ident = ref.BFF_MODES[mode][0]
    n_rows = tile_row_ptr.shape[0] - 1
    out = torch.full((n_rows * t,), ident, dtype=torch.float32,
                     device=x3.device)
    if items is None:
        items = cut_rows(tile_row_ptr, bit_tiles, BFF_ITEM_WORK, by_bits=True)
    check_items(items, x3.device)
    if items.n_items:
        scratch = torch.empty(max(items.n_slots, 1) * t, dtype=torch.float32,
                              device=x3.device)
        common.call(SOURCE, "bmv_bff", _BFF_ARGS, x3, tile_col_idx.data_ptr(),
                    bit_tiles.data_ptr(), items.row.data_ptr(),
                    items.begin.data_ptr(), items.slot.data_ptr(),
                    items.n_items, items.cut_row.data_ptr(),
                    items.cut_first.data_ptr(), items.cut_count.data_ptr(),
                    items.cut_row.numel(), x3.data_ptr(), scratch.data_ptr(),
                    out.data_ptr(), t, BFF_MODE_IDS[mode], float(a_value),
                    ident)
        bmv_bff.launches += 1
    return out


def bmv_bbf(tile_row_ptr: torch.Tensor, tile_col_idx: torch.Tensor,
            bit_tiles: torch.Tensor, x: torch.Tensor, *, t: int,
            items: Optional[WorkItems] = None) -> torch.Tensor:
    """Count mxv: ``int32[R * t]``, ``Σ_k popcount(tile_k[r] & x[col_k])``.
    ``items`` (default: cut by tiles, :data:`BBF_ITEM_WORK`) must be a cut
    of these arrays."""
    if not x.is_cuda:
        return ref.bmv_bbf(tile_row_ptr, tile_col_idx, bit_tiles, x, t=t)
    _check(tile_row_ptr, tile_col_idx, bit_tiles, x, None, t)
    n_rows = tile_row_ptr.shape[0] - 1
    out = torch.zeros(n_rows * t, dtype=torch.int32, device=x.device)
    if items is None:
        items = cut_rows(tile_row_ptr, bit_tiles, BBF_ITEM_WORK)
    check_items(items, x.device)
    if items.n_items:
        common.call(SOURCE, "bmv_bbf", _BBF_ARGS, x, tile_col_idx.data_ptr(),
                    bit_tiles.data_ptr(), items.row.data_ptr(),
                    items.begin.data_ptr(), items.slot.data_ptr(),
                    items.n_items, x.data_ptr(), out.data_ptr(), t)
        bmv_bbf.launches += 1
    return out


bmv_bbb_push.launches = 0
bmv_bbb_pull.launches = 0
bmv_bff.launches = 0
bmv_bbf.launches = 0
