"""The bit-packing entry points, with the reference wrappers' shapes
(``repro.kernels.bitpack.ops``).

The reference pads its operands to whole tiles before its Pallas calls;
the port's kernels take them unpadded and give the same words. There is
no registry row here: ``pack_columns`` is what ``gnn_bit.binarize``
calls, and ``pack_dense`` and ``bit_transpose`` are tools for callers
and tests, as in the reference. They take any strided operand (a
transposed view too) and hand the kernels a contiguous copy.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.bitpack import bitpack


def pack_dense(x: torch.Tensor, t: int, col_major: bool = False
               ) -> torch.Tensor:
    """Dense 0/1 ``[n, m]`` -> ``int32[ceil(n/t), ceil(m/t), t]`` tiles."""
    return bitpack.pack_dense(x.contiguous(), t, col_major)


def pack_columns(x: torch.Tensor, t: int) -> torch.Tensor:
    """Dense ``[n, d]`` -> ``int32[ceil(n/t), d]`` activation words
    (``BitMatrix``): binarizes with ``x != 0`` and packs the node axis
    LSB first; each feature column stays one word."""
    return bitpack.pack_rows(x.contiguous(), t)


def bit_transpose(words: torch.Tensor, t: int) -> torch.Tensor:
    """Per-tile bit transpose of words ``[..., t]`` (any leading shape)."""
    flat = words.reshape(-1, t).contiguous()
    return bitpack.bit_transpose(flat, t).reshape(words.shape)
