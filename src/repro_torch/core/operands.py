"""Typed operand wrappers for the generic GraphBLAS operation API.

``BitVector`` is the packed frontier / visited-set vector: one int32
bit-pattern word per ``tile_dim`` entries, LSB first (the
``pack_bitvector`` layout). ``FrontierBatch`` is the multi-source twin:
S such vectors packed 32 sources to a word (``pack_frontier_matrix``).
``BitMatrix`` holds binarized activations of the BitGNN layers, one
word column per feature. Plain tensors are dense vectors or matrices,
and a ``GraphMatrix`` is the SpGEMM operand.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core.b2sr import (SOURCE_WORD_BITS, pack_bitmatrix,
                                   pack_bitvector, pack_frontier_matrix,
                                   unpack_bitmatrix, unpack_bitvector,
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


@dataclasses.dataclass(frozen=True)
class BitMatrix:
    """A bit-packed binarized activation matrix (BitGNN layer input).

    ``words[c, j]`` packs entries ``X[c*t .. c*t + t-1, j]`` LSB first
    (only the low ``tile_dim`` bits are used): the node axis shares the
    ``pack_bitvector`` tile layout, so a B2SR column index picks a word
    row, while each feature keeps its own word column. The bitmat mxm
    rows sum ``popcount(tile_word & word)`` over these words, the (+, AND)
    semiring of the XNOR formulation; sign decoding and the α scale live
    in ``repro_torch.gnn_bit``.
    """

    words: torch.Tensor         # int32[ceil(n / tile_dim), d]
    n: int                      # logical node count (trailing pad bits 0)
    tile_dim: int

    @classmethod
    def pack(cls, x: torch.Tensor, tile_dim: int,
             n: Optional[int] = None) -> "BitMatrix":
        """Binarize (``x != 0``) and pack a dense ``[n, d]`` along n."""
        n = int(x.shape[0]) if n is None else n
        return cls(words=pack_bitmatrix(x, tile_dim, n), n=n,
                   tile_dim=tile_dim)

    @classmethod
    def from_words(cls, words: torch.Tensor, n: int,
                   tile_dim: int) -> "BitMatrix":
        if words.dtype != WORD or words.dim() != 2:
            raise TypeError(f"BitMatrix words must be int32 bit patterns "
                            f"[tiles, d], got {words.dtype} "
                            f"{tuple(words.shape)}")
        return cls(words=words, n=n, tile_dim=tile_dim)

    @property
    def d(self) -> int:
        """Feature width (one word column per feature)."""
        return int(self.words.shape[1])

    def unpack(self, dtype=torch.float32) -> torch.Tensor:
        return unpack_bitmatrix(self.words, self.tile_dim, self.n, dtype)

    def any(self) -> torch.Tensor:
        """Whether any bit is set (a device tensor; no host sync)."""
        return torch.any(self.words != 0)

    def _like(self, words: torch.Tensor) -> "BitMatrix":
        return BitMatrix(words=words, n=self.n, tile_dim=self.tile_dim)

    def __or__(self, other: "BitMatrix") -> "BitMatrix":
        return self._like(self.words | other.words)

    def __and__(self, other: "BitMatrix") -> "BitMatrix":
        return self._like(self.words & other.words)

    def __invert__(self) -> "BitMatrix":
        # pad bits above ``n`` flip to 1; the schemes never read past
        # n_tile_cols and ``unpack`` slices them off
        return self._like(~self.words)


def operand_kind(x) -> str:
    """Classify a right-hand operand for dispatch: the Table II/III column."""
    if isinstance(x, BitVector):
        return "bitvec"
    if isinstance(x, FrontierBatch):
        return "frontier"
    if isinstance(x, BitMatrix):
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
    if isinstance(x, BitMatrix) and x.words.shape[0] != -(-n // tile_dim):
        raise ValueError(f"{what} has {x.words.shape[0]} word rows, "
                         f"expected {-(-n // tile_dim)}")
