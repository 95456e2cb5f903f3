"""Synthetic graph generators (numpy, seeded): the port's own copy.

The same generators, with the same random streams, as
``repro.data.graphs``, so a seed gives the same COO in both packages.
All return undirected simple graphs as (rows, cols) COO with both edge
directions and no self-loops.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

Coo = Tuple[np.ndarray, np.ndarray]


def _dedup_sym(rows: np.ndarray, cols: np.ndarray, n: int) -> Coo:
    keep = rows != cols
    rows, cols = rows[keep], cols[keep]
    r = np.concatenate([rows, cols])
    c = np.concatenate([cols, rows])
    key = r.astype(np.int64) * n + c
    _, idx = np.unique(key, return_index=True)
    return r[idx], c[idx]


def dot_graph(n: int, density: float = 0.01, seed: int = 0) -> Coo:
    """Random scatter ('Dot' pattern, Erdős–Rényi)."""
    rng = np.random.default_rng(seed)
    m = int(n * n * density / 2)
    rows = rng.integers(0, n, m)
    cols = rng.integers(0, n, m)
    return _dedup_sym(rows, cols, n)


def road_graph(side: int) -> Coo:
    """2-D grid ('Road' pattern: regular planar distribution)."""
    n = side * side
    idx = np.arange(n).reshape(side, side)
    rows_list = [idx[:, :-1].ravel(), idx[:-1, :].ravel()]
    cols_list = [idx[:, 1:].ravel(), idx[1:, :].ravel()]
    return _dedup_sym(np.concatenate(rows_list), np.concatenate(cols_list), n)


def powerlaw_graph(n: int, avg_degree: int = 8, seed: int = 0) -> Coo:
    """Preferential-attachment-ish power-law graph."""
    rng = np.random.default_rng(seed)
    m = n * avg_degree // 2
    p = 1.0 / np.arange(1, n + 1)
    p /= p.sum()
    rows = rng.choice(n, size=m, p=p)
    cols = rng.integers(0, n, m)
    return _dedup_sym(rows, cols, n)


def rmat_graph(n: int, avg_degree: int = 8, a: float = 0.57, b: float = 0.19,
               c: float = 0.19, seed: int = 0,
               symmetric: bool = True) -> Coo:
    """R-MAT / Graph500-style recursive power-law generator (Kronecker).

    Each edge picks one quadrant per bit level with probabilities
    (a, b, c, d = 1-a-b-c); the defaults are the Graph500 parameters.
    ``symmetric=False`` keeps the raw directed edges (dedup'd, no self
    loops).
    """
    rng = np.random.default_rng(seed)
    scale = int(np.ceil(np.log2(max(n, 2))))
    m = max(n * avg_degree // (2 if symmetric else 1), 1)
    rows = np.zeros(m, np.int64)
    cols = np.zeros(m, np.int64)
    for _ in range(scale):
        r = rng.random(m)
        row_bit = (r >= a + b).astype(np.int64)            # quadrants c, d
        col_bit = (((r >= a) & (r < a + b)) | (r >= a + b + c)).astype(np.int64)
        rows = (rows << 1) | row_bit
        cols = (cols << 1) | col_bit
    # non-pow2 n: fold the 2^scale domain back instead of dropping edges
    rows %= n
    cols %= n
    if symmetric:
        return _dedup_sym(rows, cols, n)
    keep = rows != cols
    rows, cols = rows[keep], cols[keep]
    key = rows * n + cols
    _, idx = np.unique(key, return_index=True)
    return rows[idx], cols[idx]
