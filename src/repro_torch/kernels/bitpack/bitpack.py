"""Launchers for the bit-packing CUDA kernels in ``bitpack.cu``.

  pack_rows      replaces ``repro.kernels.bitpack.bitpack.pack_rows_pallas``
                 (``[n, D]`` 0/1 -> ``BitMatrix`` words, the node axis
                 packed)
  pack_dense     replaces ``repro.kernels.bitpack.bitpack.pack_dense_pallas``
                 (``[n, m]`` 0/1 -> packed tiles, row- or column-major)
  bit_transpose  replaces
                 ``repro.kernels.bitpack.bitpack.bit_transpose_pallas``
                 (per-tile bit transpose of ``[N, t]`` words)

Inputs are taken unpadded (the kernels treat rows and columns past the
end as 0); an entry is a set bit when it is non-zero. bool, uint8, int8,
int32 and float32 go to the kernels as they are; another dtype is
binarized to bool first. A CUDA tensor goes to the kernel: a build or
launch failure raises. A CPU tensor goes to the plain version in
``ref.py``. Each wrapper counts its launches in its ``launches``
attribute.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.core.b2sr import TILE_DIMS, ceil_div
from repro_torch.core.words import WORD
from repro_torch.kernels import common
from repro_torch.kernels.bitpack import ref
from repro_torch.obs.cost import counted, nbytes

SOURCE = Path(__file__).with_name("bitpack.cu")
_PTR, _INT, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
_ROWS_ARGS = [_PTR, _INT, _PTR, _I64, _INT, _INT, _PTR]
_DENSE_ARGS = [_PTR, _INT, _PTR, _I64, _I64, _INT, _INT, _PTR]
_TRANSPOSE_ARGS = [_PTR, _PTR, _I64, _INT, _PTR]
#: the kernels' element codes: 1-byte entries, int32, float32
_ELEM = {torch.bool: 0, torch.uint8: 0, torch.int8: 0, torch.int32: 1,
         torch.float32: 2}


def _check_t(t: int) -> None:
    if t not in TILE_DIMS:
        raise ValueError(f"tile dim must be one of {TILE_DIMS}, got {t}")


def _entries(x: torch.Tensor, name: str) -> torch.Tensor:
    """``x`` as the kernels take it: 2-D, contiguous, a supported type."""
    if x.dim() != 2:
        raise ValueError(f"{name} must be 2-D, got {tuple(x.shape)}")
    if x.dtype not in _ELEM:
        x = x != 0
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    return x


@counted(lambda out, x, t: (nbytes(x, out), 2 * x.numel()))  # test, OR
def pack_rows(x: torch.Tensor, t: int) -> torch.Tensor:
    """``[n, D]`` -> ``int32[ceil(n/t), D]``: word ``[c, j]`` bit ``r`` is
    ``x[c*t + r, j] != 0``."""
    _check_t(t)
    x = _entries(x, "x")
    if x.device.type != "cuda":
        return ref.pack_rows(x, t)
    n, d = x.shape
    out = torch.empty((ceil_div(n, t), d), dtype=WORD, device=x.device)
    if out.numel():
        common.call(SOURCE, "pack_rows", _ROWS_ARGS, x, x.data_ptr(),
                    _ELEM[x.dtype], out.data_ptr(), n, d, t)
        pack_rows.launches += 1
    return out


def pack_dense(x: torch.Tensor, t: int, col_major: bool = False
               ) -> torch.Tensor:
    """``[n, m]`` -> ``int32[ceil(n/t), ceil(m/t), t]`` tiles: row-major
    word ``[R, C, r]`` bit ``c`` is ``x[R*t + r, C*t + c] != 0``;
    column-major swaps ``r`` and ``c``."""
    _check_t(t)
    x = _entries(x, "x")
    if x.device.type != "cuda":
        return ref.pack_dense(x, t, col_major)
    n, m = x.shape
    out = torch.empty((ceil_div(n, t), ceil_div(m, t), t), dtype=WORD,
                      device=x.device)
    if out.numel():
        common.call(SOURCE, "pack_dense", _DENSE_ARGS, x, x.data_ptr(),
                    _ELEM[x.dtype], out.data_ptr(), n, m, t, int(col_major))
        pack_dense.launches += 1
    return out


def bit_transpose(words: torch.Tensor, t: int) -> torch.Tensor:
    """``int32[N, t]`` -> ``int32[N, t]``: word ``c`` of tile ``i`` has bit
    ``r`` set iff word ``r`` of the input tile has bit ``c`` (bits at and
    above ``t`` are dropped)."""
    _check_t(t)
    if words.dim() != 2 or words.shape[1] != t:
        raise ValueError(f"words must be [N, {t}], got "
                         f"{tuple(words.shape)}")
    if words.dtype != WORD:
        raise TypeError(f"words must be int32 bit patterns, got "
                        f"{words.dtype}")
    if not words.is_contiguous():
        raise ValueError("words must be contiguous")
    if words.device.type != "cuda":
        return ref.bit_transpose(words, t)
    out = torch.empty_like(words)
    if out.numel():
        common.call(SOURCE, "bit_transpose", _TRANSPOSE_ARGS, words,
                    words.data_ptr(), out.data_ptr(), words.numel(), t)
        bit_transpose.launches += 1
    return out


pack_rows.launches = 0
pack_dense.launches = 0
bit_transpose.launches = 0
