"""Typed operand wrappers for the generic GraphBLAS operation API.

``BitVector`` is the packed frontier / visited-set vector: one int32
bit-pattern word per ``tile_dim`` entries, LSB first (the
``pack_bitvector`` layout). Plain tensors are dense vectors, and a
``GraphMatrix`` is the SpGEMM operand. The multi-source ``FrontierBatch``
and BitGNN ``BitMatrix`` operands come with their slices.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core.b2sr import pack_bitvector, unpack_bitvector
from repro_torch.core.words import WORD


@dataclasses.dataclass(frozen=True)
class BitVector:
    """A bit-packed boolean vector: one word per ``tile_dim`` entries."""

    words: torch.Tensor         # int32[ceil(n / tile_dim)]
    n: int                      # logical length (trailing pad bits are 0)
    tile_dim: int

    @classmethod
    def pack(cls, x: torch.Tensor, tile_dim: int,
             n: Optional[int] = None) -> "BitVector":
        n = int(x.shape[0]) if n is None else n
        return cls(words=pack_bitvector(x, tile_dim, n), n=n,
                   tile_dim=tile_dim)

    @classmethod
    def from_words(cls, words: torch.Tensor, n: int,
                   tile_dim: int) -> "BitVector":
        if words.dtype != WORD:
            raise TypeError(f"BitVector words must be int32 bit patterns, "
                            f"got {words.dtype}")
        return cls(words=words, n=n, tile_dim=tile_dim)

    def unpack(self, dtype=torch.float32) -> torch.Tensor:
        return unpack_bitvector(self.words, self.tile_dim, self.n, dtype)

    def any(self) -> torch.Tensor:
        """Whether any bit is set (a device tensor; no host sync)."""
        return torch.any(self.words != 0)

    def _like(self, words: torch.Tensor) -> "BitVector":
        return BitVector(words=words, n=self.n, tile_dim=self.tile_dim)

    def __or__(self, other: "BitVector") -> "BitVector":
        return self._like(self.words | other.words)

    def __and__(self, other: "BitVector") -> "BitVector":
        return self._like(self.words & other.words)

    def __invert__(self) -> "BitVector":
        # pad bits above ``n`` flip to 1; the schemes never read them
        return self._like(~self.words)


def operand_kind(x) -> str:
    """Classify a right-hand operand for dispatch: the Table II/III column."""
    if isinstance(x, BitVector):
        return "bitvec"
    # GraphMatrix, structurally (it lives above this module); ``fwd`` is a
    # plain field, where reading ``csr`` would build the lazy CSR twin
    if hasattr(x, "b2sr") and hasattr(x, "fwd"):
        return "graph"
    return "dense"


def check_operand(x, tile_dim: int, n: int, what: str) -> None:
    """Validate a packed operand's metadata against the matrix."""
    if x.tile_dim != tile_dim:
        raise ValueError(f"{what} tile_dim {x.tile_dim} != matrix tile_dim "
                         f"{tile_dim}")
    if x.n != n:
        raise ValueError(f"{what} length {x.n} != expected {n}")
