"""Launchers for the B2SR SpMM CUDA kernels in ``spmm.cu``.

  spmm_bbb    replaces ``repro.kernels.spmm.spmm.spmm_bbb_pallas``
              (multi-frontier traversal over packed frontier matrices)
  spmm_dense  replaces ``repro.kernels.spmm.spmm.spmm_pallas``
              (``Y = A · X`` with a dense float32 ``X``)
  spmm_bbf    replaces ``repro.kernels.spmm.spmm.spmm_bbf_pallas``
              (popcount counts of A over ``BitMatrix`` words: the BitGNN
              aggregation)

All three take the B2SR as it is (no ELL padding, one launch per call) and
cut each tile-row into work items (``kernels/items.py``), runs of its
tiles of bounded work that a warp takes each, so that a hub tile-row
spreads over many warps; a caller may pass the items it keeps for the
matrix (the ``b2sr_cuda`` rows do). Any cut gives the same result.

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

from repro_torch.core.b2sr import B2SR
from repro_torch.core.words import WORD
from repro_torch.kernels import common
from repro_torch.kernels.items import WorkItems, check_items, work_items
from repro_torch.kernels.spmm import ref
from repro_torch.obs.cost import counted, nbytes

SOURCE = Path(__file__).with_name("spmm.cu")
_PTR, _INT = ctypes.c_void_p, ctypes.c_int
_BBB_ARGS = [_PTR] * 5 + [_INT] + [_PTR] * 4 + [_INT] * 4 + [_PTR]
_DENSE_ARGS = [_PTR] * 5 + [_INT] + [_PTR] * 3 + [_INT] + [_PTR] * 3 + \
    [_INT] * 4 + [_PTR]
_BBF_ARGS = [_PTR] * 5 + [_INT] + [_PTR] * 2 + [_INT] * 2 + [_PTR]
#: work of a ``spmm_bbb`` item, in tiles: a warp reads 32 tiles a step,
#: so an item is 8 steps. On an H100 over an msbfs (auto) of 64 sources at
#: R-MAT scale 21 (``tools/spmm_variants.py --kernel bbb``), items of 256
#: tiles took 1.19-1.20 ms a launch, 128: 1.27-1.28, 512: 1.31-1.32,
#: 1,024: 1.39
BBB_ITEM_WORK = 256
#: work of a ``spmm_bbf`` item, in tiles: the cut ``bmv_bbf`` keeps, so
#: the graph holds one cut for both. On an H100 at R-MAT scale 21, D = 16
#: (``tools/spmm_variants.py --kernel bbf``) it took 3.36-3.41 ms a
#: launch; items of 768 set bits took 3.19-3.23, but that cut costs a
#: popcount pass over the tiles (0.14 s) that ~800 launches pay back
BBF_ITEM_WORK = 256
#: work of a ``spmm_dense`` item, in set bits plus one per tile (the warp
#: reads a row of X per set bit); a longer tile-row is cut, its items'
#: partial sums added in a second launch
DENSE_ITEM_WORK = 2048
#: columns a ``spmm_dense`` lane takes per pass over its staged entries
#: (the kernel's template instances); a pass covers 32 · V columns
DENSE_VECS = (1, 2, 4, 8)


def dense_vec(d: int) -> int:
    """V for an X of ``d`` columns: the least of :data:`DENSE_VECS` whose
    pass covers ``d``, else the widest. On an H100 at R-MAT scale 21
    (``tools/spmm_variants.py``) that V was the fastest at D = 32, 64 and
    1,433, and tied with V = 2 at D = 128 (11.4 ms)."""
    return next((v for v in DENSE_VECS if 32 * v >= d), DENSE_VECS[-1])


def _check_words(name: str, a: torch.Tensor, shape, device) -> None:
    if a.device != device:
        raise ValueError(f"{name} is on {a.device}, the matrix on {device}")
    if a.dtype != WORD:
        raise TypeError(f"{name} must be int32 bit patterns, got {a.dtype}")
    if tuple(a.shape) != tuple(shape):
        raise ValueError(f"{name} shape {tuple(a.shape)} != {tuple(shape)}")
    if not a.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_aligned(m: B2SR) -> None:
    if m.bit_tiles.numel() and m.bit_tiles.data_ptr() % 16:
        raise ValueError("bit_tiles must be 16-byte aligned (vector loads)")


def _a_bytes(m: B2SR) -> int:
    return nbytes(m.tile_row_ptr, m.tile_col_idx, m.bit_tiles)


@counted(lambda out, m, f, mask=None, **kw: (
    _a_bytes(m) + nbytes(f, mask, out),
    2 * m.bit_tiles.numel() * f.shape[2]))   # AND, OR per word and column
def spmm_bbb(m: B2SR, f: torch.Tensor, mask: Optional[torch.Tensor] = None,
             *, complement: bool = True,
             items: Optional[WorkItems] = None) -> torch.Tensor:
    """Multi-frontier traversal ``Y = A ∨.∧ F``, then ``& ~mask`` (or
    ``& mask``): ``int32[n_tile_rows, t, W]`` packed frontiers.

    ``f`` is ``int32[n_tile_cols, t, W]`` (``pack_frontier_matrix``) and
    ``mask``, ``None`` to keep every bit, has the output's shape.
    """
    t = m.tile_dim
    common.check_b2sr("a", m, f.device, t)
    if f.dim() != 3:
        raise ValueError(f"f must be [n_tile_cols, t, W], got "
                         f"{tuple(f.shape)}")
    w = f.shape[2]
    _check_words("f", f, (m.n_tile_cols, t, w), m.device)
    if mask is not None:
        _check_words("mask", mask, (m.n_tile_rows, t, w), m.device)
    if f.device.type != "cuda":
        return ref.spmm_bbb(m, f, mask, complement=complement)
    _check_aligned(m)
    if items is None:
        items = work_items(m, BBB_ITEM_WORK)
    check_items(items, m.device)
    out = torch.zeros((m.n_tile_rows, t, w), dtype=WORD, device=f.device)
    if items.n_items and w:
        fnz = torch.empty(m.n_tile_cols, dtype=WORD, device=f.device)
        common.call(SOURCE, "spmm_bbb", _BBB_ARGS, f,
                    m.tile_col_idx.data_ptr(), m.bit_tiles.data_ptr(),
                    items.row.data_ptr(), items.begin.data_ptr(),
                    items.slot.data_ptr(), items.n_items, f.data_ptr(),
                    fnz.data_ptr(),
                    None if mask is None else mask.data_ptr(),
                    out.data_ptr(), m.n_tile_cols, w, t, int(complement))
        spmm_bbb.launches += 1
    return out


@counted(lambda out, m, x, **kw: (
    _a_bytes(m) + nbytes(x, out), 2 * m.nnz * x.shape[1]))
def spmm_dense(m: B2SR, x: torch.Tensor, *,
               items: Optional[WorkItems] = None) -> torch.Tensor:
    """``Y = A · X`` with A's bits as 0/1: ``x`` float32 ``[n_cols, D]``
    (any D, unpadded), ``Y`` float32 ``[n_rows, D]``."""
    return _spmm_dense(m, x, items, None)


def _spmm_dense(m: B2SR, x: torch.Tensor, items: Optional[WorkItems],
                vec: Optional[int]) -> torch.Tensor:
    """:func:`spmm_dense` with the kernel instance of ``vec`` columns a
    lane per pass (``None``: :func:`dense_vec` of D), for measurements
    that hold the instances against each other; every V gives the same
    bits."""
    t = m.tile_dim
    common.check_b2sr("a", m, x.device, t)
    if x.dtype != torch.float32:
        raise TypeError(f"x must be float32, got {x.dtype}")
    if x.dim() != 2 or x.shape[0] != m.n_cols:
        raise ValueError(f"x shape {tuple(x.shape)} is not [{m.n_cols}, D]")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    d = x.shape[1]
    vec = dense_vec(d) if vec is None else vec
    if vec not in DENSE_VECS:
        raise ValueError(f"vec must be one of {DENSE_VECS}, got {vec}")
    if x.device.type != "cuda":
        return ref.spmm_dense(m, x)
    _check_aligned(m)
    if items is None:
        items = work_items(m, DENSE_ITEM_WORK, by_bits=True)
    check_items(items, m.device)
    y = torch.zeros((m.n_rows, d), dtype=torch.float32, device=x.device)
    if items.n_items and d:
        scratch = torch.empty((max(items.n_slots, 1), t, d),
                              dtype=torch.float32, device=x.device)
        common.call(SOURCE, "spmm_dense", _DENSE_ARGS, x,
                    m.tile_col_idx.data_ptr(), m.bit_tiles.data_ptr(),
                    items.row.data_ptr(), items.begin.data_ptr(),
                    items.slot.data_ptr(), items.n_items,
                    items.cut_row.data_ptr(), items.cut_first.data_ptr(),
                    items.cut_count.data_ptr(), items.cut_row.numel(),
                    x.data_ptr(), scratch.data_ptr(), y.data_ptr(), m.n_rows,
                    d, t, vec)
        spmm_dense.launches += 1
    return y


@counted(lambda out, m, xw, *args, **kw: (
    _a_bytes(m) + nbytes(xw, out),
    3 * m.bit_tiles.numel() * xw.shape[1]))  # AND, popcount, add
def spmm_bbf(m: B2SR, xw: torch.Tensor, out_dtype=torch.float32, *,
             items: Optional[WorkItems] = None) -> torch.Tensor:
    """BitGNN aggregation ``Y[r, j] = Σ popcount(A_word_r & xw[col, j])``
    over tiles: ``xw`` int32 ``[n_tile_cols, D]`` (``BitMatrix`` words,
    any D, unpadded), ``Y`` ``[n_rows, D]`` counts in ``out_dtype``."""
    t = m.tile_dim
    common.check_b2sr("a", m, xw.device, t)
    if xw.dim() != 2:
        raise ValueError(f"xw must be [n_tile_cols, D], got "
                         f"{tuple(xw.shape)}")
    d = xw.shape[1]
    _check_words("xw", xw, (m.n_tile_cols, d), m.device)
    if xw.device.type != "cuda":
        return ref.spmm_bbf(m, xw, out_dtype)
    _check_aligned(m)
    if items is None:
        items = work_items(m, BBF_ITEM_WORK)
    check_items(items, m.device)
    y = torch.zeros((m.n_tile_rows * t, d), dtype=torch.int32,
                    device=xw.device)
    if items.n_items and d:
        common.call(SOURCE, "spmm_bbf", _BBF_ARGS, xw,
                    m.tile_col_idx.data_ptr(), m.bit_tiles.data_ptr(),
                    items.row.data_ptr(), items.begin.data_ptr(),
                    items.slot.data_ptr(), items.n_items, xw.data_ptr(),
                    y.data_ptr(), d, t)
        spmm_bbf.launches += 1
    return y[: m.n_rows].to(out_dtype)


spmm_bbb.launches = 0
spmm_dense.launches = 0
spmm_bbf.launches = 0
