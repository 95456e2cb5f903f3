"""Sampling profiler (the paper's Algorithm 1), the port of
``repro.core.sampling``: estimate each tile size's B2SR bytes from a
sample of rows.

Numpy on the host, the reference's arithmetic in its order, so a seed
gives the same floats. The storage accounting (the paper's Table I
packing: one word of ``t`` bits per tile row, int32 indices, CSR with
float32 values) is the port's own copy of the reference's
``_STORE_BYTES``, ``_INDEX_BYTES`` and ``csr_storage_bytes``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np

from repro_torch.core.b2sr import B2SR, TILE_DIMS, ceil_div

_STORE_BYTES = {4: 1, 8: 1, 16: 2, 32: 4}
_INDEX_BYTES = 4  # int32 indices, as in the paper


def csr_storage_bytes(n_rows: int, nnz: int, value_bytes: int = 4) -> int:
    """CSR with float values (the GraphBLAST/cuSPARSE baseline layout)."""
    return _INDEX_BYTES * (n_rows + 1) + _INDEX_BYTES * nnz + value_bytes * nnz


def b2sr_storage_bytes(m: B2SR) -> int:
    """A built B2SR's bytes in the same packing (the reference's
    ``B2SR.storage_bytes``)."""
    t = m.tile_dim
    return (_INDEX_BYTES * (m.n_tile_rows + 1) + _INDEX_BYTES * m.n_tiles
            + m.n_tiles * t * _STORE_BYTES[t])


@dataclasses.dataclass(frozen=True)
class SampleProfile:
    est_b2sr_bytes: Dict[int, float]      # tile_dim -> estimated total bytes
    est_compression: Dict[int, float]     # tile_dim -> est B2SR/CSR ratio
    recommended_tile_dim: Optional[int]   # None -> stay on CSR
    sampled_rows: int


def sample_profile(row_ptr: np.ndarray, col_idx: np.ndarray, n_rows: int,
                   n_cols: int, n_samples: int = 64,
                   seed: int = 0, value_bytes: int = 4) -> SampleProfile:
    """Algorithm 1 with byte-size estimation on the tile-column counts.

    Each sampled row anchors its whole tile row (the ``k`` consecutive
    rows sharing its tiles), whose tile-column sets are unioned exactly,
    so the only error left is sampling error. The recommendation is the
    tile size of the smallest estimate, or None (stay on CSR) when no
    estimate is below CSR's bytes.
    """
    rng = np.random.default_rng(seed)
    row_ptr = np.asarray(row_ptr)
    col_idx = np.asarray(col_idx)
    n = min(n_samples, n_rows)
    sample = rng.choice(n_rows, size=n, replace=False)

    est_bytes: Dict[int, float] = {}
    est_ratio: Dict[int, float] = {}
    csr_bytes = csr_storage_bytes(n_rows, int(col_idx.shape[0]), value_bytes)

    for k in TILE_DIMS:
        n_tile_rows = ceil_div(n_rows, k)
        tile_rows = np.unique(sample // k)   # distinct sampled tile rows
        tiles_per_tile_row = np.empty(tile_rows.shape[0], dtype=np.float64)
        for idx, tr in enumerate(tile_rows):
            lo = int(tr) * k
            hi = min(lo + k, n_rows)
            s, e = int(row_ptr[lo]), int(row_ptr[hi])
            tiles_per_tile_row[idx] = (np.unique(col_idx[s:e] // k).shape[0]
                                       if e > s else 0)
        est_n_tiles = ((tiles_per_tile_row.mean() if tile_rows.size else 0.0)
                       * n_tile_rows)
        b = (_INDEX_BYTES * (n_tile_rows + 1)
             + _INDEX_BYTES * est_n_tiles
             + est_n_tiles * k * _STORE_BYTES[k])
        est_bytes[k] = float(b)
        est_ratio[k] = float(b / max(csr_bytes, 1))

    best = min(est_ratio, key=est_ratio.get)
    return SampleProfile(
        est_b2sr_bytes=est_bytes,
        est_compression=est_ratio,
        recommended_tile_dim=best if est_ratio[best] < 1.0 else None,
        sampled_rows=n,
    )
