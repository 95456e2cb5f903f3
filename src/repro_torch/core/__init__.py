"""Core: B2SR format, semirings, the generic GraphBLAS operation API."""

from repro_torch.core.b2sr import (  # noqa: F401
    B2SR,
    B2SRBucketedEll,
    B2SREll,
    TILE_DIMS,
    b2sr_to_coo,
    coo_to_b2sr,
    pack_bitvector,
    to_bucketed,
    to_ell,
    transpose,
    unpack_bitvector,
    unpack_tiles,
)
from repro_torch.core.descriptor import DEFAULT, Descriptor  # noqa: F401
from repro_torch.core.graphblas import BACKENDS, GraphMatrix  # noqa: F401
from repro_torch.core.operands import BitVector, operand_kind  # noqa: F401
from repro_torch.core.semiring import (  # noqa: F401
    ARITHMETIC,
    BOOLEAN,
    MAX_TIMES,
    MIN_PLUS,
    SEMIRINGS,
    Semiring,
)
