"""Plain PyTorch versions of the bit-packing kernels (``bitpack.cu``).

Same inputs as the CUDA wrappers in ``bitpack.py``; the CPU path and the
tests use them, and on the card they are the yardstick the kernels are
held to. They are the word-layer packers of ``repro_torch.core.b2sr``
(shift-and-sum over unpacked bits), as the reference's oracle delegates
to its core packers.
"""

from __future__ import annotations

import torch

from repro_torch.core.b2sr import (bit_transpose_words, pack_bitmatrix,
                                   pack_dense_tiles)


def pack_rows(x: torch.Tensor, t: int) -> torch.Tensor:
    """``[n, D]`` -> ``int32[ceil(n/t), D]``, the node axis packed."""
    return pack_bitmatrix(x, t)


def pack_dense(x: torch.Tensor, t: int, col_major: bool = False
               ) -> torch.Tensor:
    """``[n, m]`` -> ``int32[ceil(n/t), ceil(m/t), t]`` tiles."""
    words = pack_dense_tiles(x, t)
    return bit_transpose_words(words, t) if col_major else words


def bit_transpose(words: torch.Tensor, t: int) -> torch.Tensor:
    """``int32[N, t]`` -> the bit transpose of each tile."""
    return bit_transpose_words(words, t)
