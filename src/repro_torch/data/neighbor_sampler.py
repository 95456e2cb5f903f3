"""Layered neighbour sampler (GraphSAGE-style, fanout e.g. 15-10), the
port of ``repro.data.neighbor_sampler``.

Host-side numpy over a CSR adjacency. It emits a static-shape padded
subgraph (the ``minibatch_lg`` contract): the seeds and their sampled
k-hop neighbourhood, the edge list (child → parent, the direction of
aggregation), node and edge masks and the local relabelling. The draws
are the reference's, in its order, so a seed gives equal arrays.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class SampledSubgraph:
    node_ids: np.ndarray      # [N_pad] global ids (0-padded)
    node_mask: np.ndarray     # [N_pad] bool
    senders: np.ndarray       # [E_pad] local indices
    receivers: np.ndarray     # [E_pad] local indices
    edge_mask: np.ndarray     # [E_pad] bool
    seed_mask: np.ndarray     # [N_pad] bool (loss nodes)
    n_real_nodes: int
    n_real_edges: int


def sampled_sizes(batch_nodes: int, fanout: Sequence[int]) -> Tuple[int, int]:
    """Static ``(N_pad, E_pad)`` for a seed count and fanout schedule."""
    n = total_nodes = batch_nodes
    total_edges = 0
    for f in fanout:
        e = n * f
        total_edges += e
        total_nodes += e
        n = e
    return total_nodes, total_edges


def sample(row_ptr: np.ndarray, col_idx: np.ndarray, seeds: np.ndarray,
           fanout: Sequence[int], seed: int = 0) -> SampledSubgraph:
    """Each frontier node draws ``min(f, deg)`` distinct neighbours per
    layer; new nodes are numbered in the order they are met."""
    rng = np.random.default_rng(seed)
    n_pad, e_pad = sampled_sizes(len(seeds), fanout)

    node_ids: List[int] = list(seeds)
    local = {int(g): i for i, g in enumerate(seeds)}
    senders: List[int] = []
    receivers: List[int] = []
    frontier = list(seeds)

    for f in fanout:
        next_frontier: List[int] = []
        for u in frontier:
            lo, hi = int(row_ptr[u]), int(row_ptr[u + 1])
            deg = hi - lo
            if deg == 0:
                continue
            picks = rng.choice(col_idx[lo:hi], size=min(f, deg),
                               replace=False)
            for v in picks:
                v = int(v)
                if v not in local:
                    local[v] = len(node_ids)
                    node_ids.append(v)
                # aggregation direction: neighbour (v) -> target (u)
                senders.append(local[v])
                receivers.append(local[u])
                next_frontier.append(v)
        frontier = next_frontier

    n_real, e_real = len(node_ids), len(senders)
    if n_real > n_pad or e_real > e_pad:
        raise RuntimeError("sampler exceeded static bounds")

    nid = np.zeros(n_pad, np.int64)
    nid[:n_real] = node_ids
    nmask = np.zeros(n_pad, bool)
    nmask[:n_real] = True
    snd = np.zeros(e_pad, np.int32)
    rcv = np.zeros(e_pad, np.int32)
    snd[:e_real] = senders
    rcv[:e_real] = receivers
    emask = np.zeros(e_pad, bool)
    emask[:e_real] = True
    smask = np.zeros(n_pad, bool)
    smask[: len(seeds)] = True
    return SampledSubgraph(nid, nmask, snd, rcv, emask, smask, n_real, e_real)
