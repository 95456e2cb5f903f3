"""Launcher for the boolean B2SR SpGEMM in ``spgemm.cu``.

  spgemm_bbb  replaces ``repro.kernels.spgemm.spgemm.mxm_bin_bin_bin_pallas``

``spgemm_bbb(a, b, mask, complement=)`` is C⟨M⟩ (or C⟨¬M⟩) = A ∨.∧ B as
a B2SR. A window pass sorts A's tile-rows into heavy rows (at least
:data:`HEAVY_PAIRS` (A tile, B tile) pairs; the list ordered by pairs,
most first) and light ones; then a count and a fill pass run over each
list that is not empty, heavy rows in blocks of :data:`THREADS_LONG`
threads, light ones in blocks of :data:`THREADS_SHORT`. The fill pass builds each of C's tile-rows in
shared memory and stores every tile once with a flag (not zero) and each
row's count of non-zero tiles and set bits; when a tile came out zero (a
product tile can be zero, and the mask can zero one) the wrapper keeps
the flagged tiles, the reference's ``packed_grid_to_b2sr`` step on a
sparse list. A CUDA tensor goes to the kernel (a build or launch failure
raises); a CPU tensor to the plain version in ``ref.py``.
``spgemm_bbb.launches`` counts the calls that launched it (each call
makes three to five kernel launches).
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import List, Optional, Tuple

import torch

from repro_torch.core.b2sr import B2SR
from repro_torch.kernels import common
from repro_torch.kernels.spgemm import ref

SOURCE = Path(__file__).with_name("spgemm.cu")
_PTR, _INT, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
_ARGS = [_PTR] * 10 + [_INT] + [_PTR] * 6 + [_I64] + [_PTR] * 5 + \
    [_INT, _I64] + [_INT] * 5 + [ctypes.POINTER(ctypes.c_int), _PTR, _PTR]
_MASK_MODE = {None: 0, False: 1, True: 2}
#: (A tile, B tile) pairs from which a tile-row of A is heavy, and the
#: ``heavy`` of :func:`_spgemm_bbb` that makes no row heavy. On an H100
#: (``tools/spgemm_variants.py``) 1,024 beat 4,096 and 16,384 on every
#: input: a light row of a few thousand pairs on one warp is a tail
HEAVY_PAIRS = 1024
NEVER = 1 << 62
#: threads a block for heavy rows and for light ones. On an H100, A² of
#: R-MAT scale 16 (all rows but a few heavy) took 14.9-15.3 ms with
#: 1,024 threads, 21.1-22.7 with 512 and 30.4-38.6 with 256; one
#: road-grid hop (all rows light) 1.10-1.15 ms with 32 threads (one warp
#: a row), 1.48-1.60 with 64, 2.19-2.41 with 128 and 4.14-4.57 with 256
#: (``tools/spgemm_variants.py``)
THREADS_LONG, THREADS_SHORT = 1024, 32
#: most slots (tiles of C's row) a round of the fill pass holds, for heavy
#: rows and for light ones; the launcher takes fewer where the shared
#: memory is smaller, and the wrapper no more than the list's widest row
#: of C needs. On an H100, A² of R-MAT scale 16 took 14.9-15.3 ms at
#: 1,024 slots (two rounds), 20.3-20.5 at 512, 29.4-30.2 at 256; light
#: rows have fewer than HEAVY_PAIRS pairs, and a small cap lets many
#: one-warp blocks share an SM
SLOTS, SLOTS_SHORT = 1024, 64
#: A's tiles a tile-row holds on average from which the window pass takes
#: a warp per row (else a thread, and a warp for each row of more than 32)
LONG_ROW = 32


def window_by_warps(a: B2SR) -> bool:
    """Whether the window pass scans a row with a warp: A's tile-rows hold
    :data:`LONG_ROW` tiles or more on average (R-MAT scale 16: 232; a road
    grid: 5)."""
    return a.n_tiles >= LONG_ROW * max(a.n_tile_rows, 1)


def compact(out_col: torch.Tensor, out_tiles: torch.Tensor,
            out_flag: torch.Tensor, row_nz: torch.Tensor,
            row_bits: torch.Tensor
            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, int]:
    """(tile_row_ptr, tile_col_idx, bit_tiles, set bits) of C from the
    fill pass's slots: every slot when each is flagged (no tile came out
    zero), else the flagged ones, in order. ``row_nz`` and ``row_bits``
    count each row's flags and set bits."""
    ptr = torch.zeros(row_nz.shape[0] + 1, dtype=torch.int64,
                      device=row_nz.device)
    torch.cumsum(row_nz, 0, out=ptr[1:])
    kept, nnz = torch.stack([ptr[-1], row_bits.sum()]).tolist()
    if kept != out_col.shape[0]:
        idx = torch.nonzero_static(out_flag, size=kept).squeeze(1)
        out_col, out_tiles = out_col[idx], out_tiles[idx]
    return ptr.to(torch.int32), out_col, out_tiles, nnz


def spgemm_bbb(a: B2SR, b: B2SR, mask: Optional[B2SR] = None, *,
               complement: bool = False) -> B2SR:
    """Boolean SpGEMM of B2SR ``a`` [R x K] and ``b`` [K x C], masked by
    ``mask`` [R x C] (its complement with ``complement=True``) before the
    store. The tile-rows of ``a``, ``b`` and ``mask`` must be sorted by
    column, as every B2SR constructor of the port makes them (the kernel
    takes each B row's first and last column as its extent). Returns C
    with sorted tile-rows and no all-zero tile; ``nnz`` counts its
    bits."""
    return _spgemm_bbb(a, b, mask, complement)


def _spgemm_bbb(a: B2SR, b: B2SR, mask: Optional[B2SR], complement: bool,
                heavy: Optional[int] = None,
                threads: Tuple[int, int] = (THREADS_LONG, THREADS_SHORT),
                slots: Tuple[int, int] = (SLOTS, SLOTS_SHORT),
                events: Optional[List] = None) -> B2SR:
    """:func:`spgemm_bbb` with the pairs that make a row heavy (``None``:
    :data:`HEAVY_PAIRS`; 0: every row, :data:`NEVER`: none), and the
    threads a block and most slots a round of the heavy and of the light
    rows, set by the caller for measurements; every setting gives the same
    C. With ``events`` (a list), appends ``(name, start, end, (threads,
    slots, run))`` for each launch (``window``, ``count/heavy``,
    ``count/light``, ``fill/heavy``, ``fill/light``): CUDA events around
    it and the shape the kernel took (the fill's slots a round and tiles
    of A a run)."""
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
    for name, m in (("a", a), ("b", b), ("mask", mask)):
        if m is not None and m.bit_tiles.numel() and \
                m.bit_tiles.data_ptr() % 16:
            raise ValueError(f"{name}.bit_tiles must be 16-byte aligned "
                             f"(vector loads)")
    n_tr = a.n_tile_rows
    heavy = HEAVY_PAIRS if heavy is None else heavy
    # int32: the four launches' row counters (count, fill; heavy, light),
    # the plan (each list's widest window, its rows, its widest row of C),
    # each row's first bitmap word, the heavy and the light list, B's row
    # occupancy; int64: each row's pairs, tiles of C, their exclusive
    # scan, its non-zero tiles and set bits
    i32 = torch.empty(10 + 3 * n_tr + b.n_tiles, dtype=torch.int32,
                      device=dev)
    i32[:10].zero_()
    counter, plan = i32[:4], i32[4:10]
    row_lo, rows = i32[10:10 + n_tr], i32[10 + n_tr:10 + 3 * n_tr]
    b_occ = i32[10 + 3 * n_tr:]
    i64 = torch.empty(5 * n_tr + 1, dtype=torch.int64, device=dev)
    pairs, counts = i64[:n_tr], i64[n_tr:2 * n_tr]
    offsets = i64[2 * n_tr:3 * n_tr + 1]
    row_nz, row_bits = i64[3 * n_tr + 1:4 * n_tr + 1], i64[4 * n_tr + 1:]
    m_ptrs = ((None,) * 3 if mask is None else
              (mask.tile_row_ptr.data_ptr(), mask.tile_col_idx.data_ptr(),
               mask.bit_tiles.data_ptr()))
    mode = _MASK_MODE[None if mask is None else bool(complement)]
    shape = (ctypes.c_int * 3)()

    def launch(name, pass_, row_off, lst, widest, n_rows, outs, n_words,
               th, n_slots, ctr):
        start = end = None
        if events is not None:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
        common.call(SOURCE, "spgemm_bbb", _ARGS, a.bit_tiles,
                    *(p.data_ptr() for p in (a.tile_row_ptr, a.tile_col_idx,
                                             a.bit_tiles, b.tile_row_ptr,
                                             b.tile_col_idx, b.bit_tiles,
                                             b_occ)),
                    *m_ptrs, mode, row_off, row_lo.data_ptr(),
                    pairs.data_ptr(), plan.data_ptr(), lst, widest, heavy,
                    *outs, n_rows, b.n_tiles, n_words, t, pass_, th, n_slots,
                    shape, ctr)
        if events is not None:
            end.record()
            events.append((name, start, end, tuple(shape)))

    # each list: (index, name, first row in rows, its rows, widest window)
    lists = []
    if n_tr:
        launch("window", 0, None, rows.data_ptr(), None, n_tr, (None,) * 5,
               0, THREADS_LONG if window_by_warps(a) else THREADS_SHORT, 1,
               None)
        span_heavy, span_light, n_heavy, n_light = plan[:4].tolist()
        lists = [lst for lst in ((0, "heavy", 0, n_heavy, span_heavy),
                                 (1, "light", n_tr, n_light, span_light))
                 if lst[3]]
        if n_heavy > 1:      # the heavy rows by pairs, most first
            h = rows[:n_heavy].long()
            rows[:n_heavy] = h[torch.sort(pairs[h], descending=True,
                                          stable=True).indices]
        for i, name, first, n, span in lists:
            launch(f"count/{name}", 1, counts.data_ptr(),
                   rows[first:].data_ptr(), plan[4 + i].data_ptr(), n,
                   (None,) * 5, span, threads[i], 1, counter[i].data_ptr())
    offsets[0] = 0
    total, widest = 0, [0, 0]  # C's tiles, each list's widest row of C
    if n_tr:
        torch.cumsum(counts, 0, out=offsets[1:])
        total, *widest = torch.cat([offsets[-1:],
                                    plan[4:].long()]).tolist()
    out_tiles = torch.empty((total, t), dtype=torch.int32, device=dev)
    out_col = torch.empty(total, dtype=torch.int32, device=dev)
    out_flag = torch.empty(total, dtype=torch.uint8, device=dev)
    if total:
        outs = tuple(x.data_ptr() for x in (out_col, out_tiles, out_flag,
                                            row_nz, row_bits))
        for i, name, first, n, span in lists:
            launch(f"fill/{name}", 2, offsets.data_ptr(),
                   rows[first:].data_ptr(), None, n, outs, span, threads[i],
                   max(1, min(slots[i], widest[i])),
                   counter[2 + i].data_ptr())
    else:
        row_nz.zero_()
        row_bits.zero_()
    if n_tr:
        spgemm_bbb.launches += 1
    ptr, col, tiles, nnz = compact(out_col, out_tiles, out_flag, row_nz,
                                   row_bits)
    return B2SR(tile_row_ptr=ptr, tile_col_idx=col, bit_tiles=tiles,
                tile_dim=t, n_rows=a.n_rows, n_cols=b.n_cols, nnz=nnz)


spgemm_bbb.launches = 0
