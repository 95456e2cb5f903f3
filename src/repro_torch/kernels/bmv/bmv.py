"""Launchers for the boolean B2SR mxv CUDA kernels in ``bmv.cu``.

``bmv_bbb_push`` replaces ``repro.kernels.bmv.bmv.bmv_bin_bin_bin_pallas``
and ``bmv_bbb_pull`` replaces ``bmv_bin_bin_bin_pull_pallas``. Both take
the B2SR CSR-over-tiles arrays as they are (no ELL padding, one launch).

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

SOURCE = Path(__file__).with_name("bmv.cu")
_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [ctypes.c_void_p]


def _check(tile_row_ptr, tile_col_idx, bit_tiles, x, mask, t: int) -> None:
    """Validate what the kernels take: devices, dtypes, shapes, layout."""
    named = {"tile_row_ptr": tile_row_ptr, "tile_col_idx": tile_col_idx,
             "bit_tiles": bit_tiles, "x": x}
    if mask is not None:
        named["mask"] = mask
    for name, a in named.items():
        if a.device != x.device:
            raise ValueError(f"{name} is on {a.device}, x on {x.device}")
        if a.dtype != WORD:
            raise TypeError(f"{name} must be int32, got {a.dtype}")
        if not a.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    n_rows = tile_row_ptr.shape[0] - 1
    if t not in (4, 8, 16, 32):
        raise ValueError(f"tile dim must be 4, 8, 16 or 32, got {t}")
    if bit_tiles.dim() != 2 or bit_tiles.shape != (tile_col_idx.shape[0], t):
        raise ValueError(f"bit_tiles shape {tuple(bit_tiles.shape)} != "
                         f"({tile_col_idx.shape[0]}, {t})")
    if mask is not None and mask.shape != (n_rows,):
        raise ValueError(f"mask shape {tuple(mask.shape)} != ({n_rows},)")
    if bit_tiles.numel() and bit_tiles.data_ptr() % 16:
        raise ValueError("bit_tiles must be 16-byte aligned (vector loads)")


def _launch(name: str, tile_row_ptr, tile_col_idx, bit_tiles, x, mask, t: int,
            complement: bool) -> Optional[torch.Tensor]:
    """Launch kernel ``name``; returns ``None`` when there is no row."""
    _check(tile_row_ptr, tile_col_idx, bit_tiles, x, mask, t)
    n_rows = tile_row_ptr.shape[0] - 1
    if n_rows == 0:
        return None
    out = torch.empty(n_rows, dtype=WORD, device=x.device)
    lib = common.load_library(SOURCE)
    fn = getattr(lib, name)
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    with torch.cuda.device(x.device):
        err = fn(tile_row_ptr.data_ptr(), tile_col_idx.data_ptr(),
                 bit_tiles.data_ptr(), x.data_ptr(),
                 None if mask is None else mask.data_ptr(), out.data_ptr(),
                 n_rows, t, int(complement),
                 torch.cuda.current_stream().cuda_stream)
    common.check_launch(lib, err, name)
    return out


def bmv_bbb_push(tile_row_ptr: torch.Tensor, tile_col_idx: torch.Tensor,
                 bit_tiles: torch.Tensor, x: torch.Tensor,
                 mask: Optional[torch.Tensor], *, t: int,
                 complement: bool = True) -> torch.Tensor:
    """Push BFS step: ``y = OR_k hits(tile, x[col]) & (~mask | mask)``.

    ``mask=None`` keeps every lane. Returns int32[R] packed words.
    """
    if not x.is_cuda:
        return ref.bmv_bbb_push(tile_row_ptr, tile_col_idx, bit_tiles, x,
                                mask, t=t, complement=complement)
    out = _launch("bmv_bbb_push", tile_row_ptr, tile_col_idx, bit_tiles, x,
                  mask, t, complement)
    if out is None:
        return torch.zeros(0, dtype=WORD, device=x.device)
    bmv_bbb_push.launches += 1
    return out


def bmv_bbb_pull(tile_row_ptr: torch.Tensor, tile_col_idx: torch.Tensor,
                 bit_tiles: torch.Tensor, x: torch.Tensor, mask: torch.Tensor,
                 *, t: int, complement: bool = True) -> torch.Tensor:
    """Pull BFS step with per-row early exit; bit-exact with push."""
    if mask is None:
        raise ValueError("the pull step needs a mask (nothing to exit on)")
    if not x.is_cuda:
        return ref.bmv_bbb_pull(tile_row_ptr, tile_col_idx, bit_tiles, x,
                                mask, t=t, complement=complement)
    out = _launch("bmv_bbb_pull", tile_row_ptr, tile_col_idx, bit_tiles, x,
                  mask, t, complement)
    if out is None:
        return torch.zeros(0, dtype=WORD, device=x.device)
    bmv_bbb_pull.launches += 1
    return out


bmv_bbb_push.launches = 0
bmv_bbb_pull.launches = 0
