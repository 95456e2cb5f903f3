"""Typed operand wrappers for the generic GraphBLAS operation API.

``BitVector`` is the packed frontier / visited-set vector: one int32
bit-pattern word per ``tile_dim`` entries, LSB first (the
``pack_bitvector`` layout). ``FrontierBatch`` is the multi-source twin:
S such vectors packed 32 sources to a word (``pack_frontier_matrix``).
Plain tensors are dense vectors or matrices, and a ``GraphMatrix`` is
the SpGEMM operand. The BitGNN ``BitMatrix`` operand comes with its
slice (ROADMAP Queue 1 item 7).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core.b2sr import (SOURCE_WORD_BITS, pack_bitvector,
                                   pack_frontier_matrix, unpack_bitvector,
                                   unpack_frontier_matrix)
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


@dataclasses.dataclass(frozen=True)
class FrontierBatch:
    """A bit-packed batch of S boolean vectors (``pack_frontier_matrix``).

    ``words[T, r, w]`` packs sources ``32w .. 32w+31`` of node ``T*t + r``
    LSB first: the node axis is tile-grouped for B2SR gathers, the batch
    axis is packed at machine width.
    """

    words: torch.Tensor         # int32[ceil(n / t), t, W]
    n: int                      # logical node count
    n_sources: int              # logical batch width S (<= 32 * W)
    tile_dim: int

    @classmethod
    def pack(cls, x: torch.Tensor, tile_dim: int,
             n: Optional[int] = None) -> "FrontierBatch":
        """Binarize + pack a dense ``[n, S]`` batch along the S axis."""
        n = int(x.shape[0]) if n is None else n
        return cls(words=pack_frontier_matrix(x, tile_dim, n), n=n,
                   n_sources=int(x.shape[1]), tile_dim=tile_dim)

    @classmethod
    def from_words(cls, words: torch.Tensor, n: int, n_sources: int,
                   tile_dim: int) -> "FrontierBatch":
        if words.dtype != WORD or words.dim() != 3:
            raise TypeError(f"FrontierBatch words must be int32 bit patterns "
                            f"[T, t, W], got {words.dtype} "
                            f"{tuple(words.shape)}")
        return cls(words=words, n=n, n_sources=n_sources, tile_dim=tile_dim)

    @property
    def padded_width(self) -> int:
        """Batch width after word padding (32 * W)."""
        return int(self.words.shape[2]) * SOURCE_WORD_BITS

    def unpack(self, dtype=torch.float32) -> torch.Tensor:
        return unpack_frontier_matrix(self.words, self.n, self.n_sources,
                                      dtype)

    def any(self) -> torch.Tensor:
        """Whether any bit is set (a device tensor; no host sync)."""
        return torch.any(self.words != 0)

    def _like(self, words: torch.Tensor) -> "FrontierBatch":
        return FrontierBatch(words=words, n=self.n, n_sources=self.n_sources,
                             tile_dim=self.tile_dim)

    def __or__(self, other: "FrontierBatch") -> "FrontierBatch":
        return self._like(self.words | other.words)

    def __and__(self, other: "FrontierBatch") -> "FrontierBatch":
        return self._like(self.words & other.words)

    def __invert__(self) -> "FrontierBatch":
        # pad bits (sources past S, nodes past n) flip to 1; the schemes
        # only AND them into words whose pad bits are 0
        return self._like(~self.words)


def operand_kind(x) -> str:
    """Classify a right-hand operand for dispatch: the Table II/III column.

    A ``BitMatrix`` (packed activations: ``words`` and a feature width
    ``d``) is recognised structurally; the port has no such operand yet.
    """
    if isinstance(x, BitVector):
        return "bitvec"
    if isinstance(x, FrontierBatch):
        return "frontier"
    if hasattr(x, "words") and hasattr(x, "d"):
        return "bitmat"
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
