"""Core: B2SR format, semirings, the generic GraphBLAS operation API."""

from repro_torch.core.b2sr import (  # noqa: F401
    B2SR,
    B2SRBucketedEll,
    B2SREll,
    SOURCE_WORD_BITS,
    TILE_DIMS,
    b2sr_to_coo,
    coo_to_b2sr,
    pack_bitvector,
    pack_frontier_matrix,
    to_bucketed,
    to_ell,
    transpose,
    unpack_bitvector,
    unpack_frontier_matrix,
    unpack_tiles,
)
from repro_torch.core.descriptor import DEFAULT, Descriptor  # noqa: F401
from repro_torch.core.graphblas import BACKENDS, GraphMatrix  # noqa: F401
from repro_torch.core.operands import (BitMatrix, BitVector,  # noqa: F401
                                      FrontierBatch, operand_kind)
from repro_torch.core.semiring import (  # noqa: F401
    ARITHMETIC,
    BOOLEAN,
    MAX_TIMES,
    MIN_PLUS,
    SEMIRINGS,
    Semiring,
)
