"""Synthetic graph generators (numpy, seeded): the port's own copy.

The same generators, with the same random streams, as
``repro.data.graphs``, so a seed gives the same COO in both packages.
The patterns are the paper's taxonomy (Table V): dot, diagonal, block,
stripe, road, hybrid, and R-MAT for skew. All return undirected simple
graphs as (rows, cols) COO with both edge directions and no self-loops.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

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


def diagonal_graph(n: int, bandwidth: int = 3, seed: int = 0,
                   fill: float = 0.6) -> Coo:
    """Banded matrix ('Diagonal' pattern: meshes, discretizations)."""
    rng = np.random.default_rng(seed)
    rows_list, cols_list = [], []
    for off in range(1, bandwidth + 1):
        i = np.arange(n - off)
        keep = rng.random(n - off) < fill
        rows_list.append(i[keep])
        cols_list.append(i[keep] + off)
    return _dedup_sym(np.concatenate(rows_list), np.concatenate(cols_list), n)


def block_graph(n: int, n_blocks: int = 8, intra_density: float = 0.3,
                inter_edges: int = 16, seed: int = 0) -> Coo:
    """Dense diagonal blocks + sparse inter-block edges ('Block' pattern)."""
    rng = np.random.default_rng(seed)
    bs = n // n_blocks
    rows_list, cols_list = [], []
    for b in range(n_blocks):
        lo = b * bs
        hi = min(lo + bs, n)
        m = int((hi - lo) ** 2 * intra_density / 2)
        rows_list.append(rng.integers(lo, hi, m))
        cols_list.append(rng.integers(lo, hi, m))
    rows_list.append(rng.integers(0, n, inter_edges))
    cols_list.append(rng.integers(0, n, inter_edges))
    return _dedup_sym(np.concatenate(rows_list), np.concatenate(cols_list), n)


def stripe_graph(n: int, n_stripes: int = 4, seed: int = 0) -> Coo:
    """A few off-diagonal lines ('Stripe' pattern)."""
    rng = np.random.default_rng(seed)
    offsets = rng.integers(1, max(n // 2, 2), n_stripes)
    rows_list, cols_list = [], []
    for off in offsets:
        i = np.arange(n - off)
        rows_list.append(i)
        cols_list.append(i + off)
    return _dedup_sym(np.concatenate(rows_list), np.concatenate(cols_list), n)


def road_graph(side: int) -> Coo:
    """2-D grid ('Road' pattern: regular planar distribution)."""
    n = side * side
    idx = np.arange(n).reshape(side, side)
    rows_list = [idx[:, :-1].ravel(), idx[:-1, :].ravel()]
    cols_list = [idx[:, 1:].ravel(), idx[1:, :].ravel()]
    return _dedup_sym(np.concatenate(rows_list), np.concatenate(cols_list), n)


def hybrid_graph(n: int, seed: int = 0) -> Coo:
    """Combination of ≥2 patterns ('Hybrid')."""
    r1, c1 = diagonal_graph(n, bandwidth=2, seed=seed)
    r2, c2 = dot_graph(n, density=4.0 / n, seed=seed + 1)
    return _dedup_sym(np.concatenate([r1, r2]), np.concatenate([c1, c2]), n)


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


#: pattern name -> ``gen(n, seed=0)``, the reference's ``PATTERNS``
PATTERNS: Dict[str, Callable[..., Coo]] = {
    "dot": lambda n, seed=0: dot_graph(
        n, density=min(0.02, 200 / n ** 2 + 0.005), seed=seed),
    "diagonal": lambda n, seed=0: diagonal_graph(n, seed=seed),
    "block": lambda n, seed=0: block_graph(n, seed=seed),
    "stripe": lambda n, seed=0: stripe_graph(n, seed=seed),
    "road": lambda n, seed=0: road_graph(int(np.sqrt(n))),
    "hybrid": lambda n, seed=0: hybrid_graph(n, seed=seed),
    "rmat": lambda n, seed=0: rmat_graph(n, seed=seed),
}


def partition_edges_by_receiver_block(rows: np.ndarray, cols: np.ndarray,
                                      n_nodes: int, n_shards: int) -> Tuple[
                                          np.ndarray, np.ndarray, np.ndarray]:
    """Receiver-block edge partition (the sharded aggregation contract).

    Groups edges by ``cols // (n_nodes/n_shards)`` and pads each group to a
    common width (padding receivers stay in-block, senders 0, mask False).
    Returns (senders, receivers, edge_mask) with len == n_shards × width:
    edge-shard i then holds exactly node-block i's incoming edges.
    """
    n_local = n_nodes // n_shards
    blk = cols // n_local
    groups = [np.flatnonzero(blk == b) for b in range(n_shards)]
    width = max((len(g) for g in groups), default=1)
    width = max(width, 1)
    pr = np.zeros((n_shards, width), np.int64)
    pc = np.zeros((n_shards, width), np.int64)
    mask = np.zeros((n_shards, width), bool)
    for b, g in enumerate(groups):
        pr[b, :len(g)] = rows[g]
        pc[b, :len(g)] = cols[g]
        pc[b, len(g):] = b * n_local
        mask[b, :len(g)] = True
    return pr.ravel(), pc.ravel(), mask.ravel()
