"""Synthetic full-graph GNN batches (numpy, seeded), the port's twin of
``repro.data.synthetic``'s ``full_graph_batch`` and ``rmat_batch``.

The draws are the reference's, in its order, from one
``np.random.default_rng(seed)``: the graph from the pattern's own seeded
generator, then the features, the labels and the train mask. So a seed
gives the same batch in both packages. The adjacency is stored with the
receivers as rows (``y[i] = Σ_{j → i} x[j]``, the reference's
``coo_to_b2sr(cols, rows, …)``) and keeps its transpose, which the dense
``mxm`` row's gradient walks; the degrees are the receivers' in-edge
counts plus one (the self loop). The egnn ``coords`` and the minibatch
and molecule batches wait for ROADMAP Queue 1 item 10.
"""

from __future__ import annotations

from functools import partial
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.configs.gnn import GNNConfig
from repro_torch.core.graphblas import GraphMatrix
from repro_torch.data import graphs as graph_gen
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.gnn.common import GraphBatch


def full_graph_batch(cfg: GNNConfig, n_nodes: int, pattern: str = "hybrid",
                     seed: int = 0, with_b2sr: Optional[bool] = None,
                     generator: Optional[Callable] = None,
                     device: DeviceLike = None) -> GraphBatch:
    """One graph of ``n_nodes`` nodes with node features, labels and a 30%
    train mask, on ``device`` (None = CUDA). ``generator(n, seed=)`` takes
    the place of ``graph_gen.PATTERNS[pattern]``. With B2SR (``with_b2sr``,
    default ``cfg.use_b2sr``) the batch carries a :class:`GraphMatrix` on
    ``cfg.tile_dim`` on ``b2sr_cuda`` (the kernels on the card, their
    plain versions on the CPU; ``graph.with_backend`` picks another)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    gen = generator if generator is not None else graph_gen.PATTERNS[pattern]
    rows, cols = gen(n_nodes, seed=seed)
    feat = rng.standard_normal((n_nodes, cfg.d_in)).astype(np.float32)
    labels = rng.integers(0, cfg.n_classes, n_nodes, dtype=np.int32)
    train_mask = rng.random(n_nodes) < 0.3
    deg = np.zeros(n_nodes, np.float32)
    np.add.at(deg, cols, 1.0)
    use_b2sr = cfg.use_b2sr if with_b2sr is None else with_b2sr
    graph = None
    if use_b2sr:
        graph = GraphMatrix.from_coo(cols, rows, n_nodes, n_nodes,
                                     cfg.tile_dim, backend="b2sr_cuda",
                                     device=dev)

    def tensor(a, dtype=None):
        return torch.as_tensor(np.asarray(a, dtype=dtype), device=dev)

    return GraphBatch(
        node_feat=tensor(feat),
        senders=tensor(rows, np.int64),
        receivers=tensor(cols, np.int64),
        edge_mask=torch.ones(rows.shape[0], dtype=torch.bool, device=dev),
        graph=graph,
        degrees=tensor(deg + 1.0),
        labels=tensor(labels, np.int64),
        train_mask=tensor(train_mask),
        node_mask=torch.ones(n_nodes, dtype=torch.bool, device=dev),
        graph_ids=torch.zeros(n_nodes, dtype=torch.int64, device=dev),
        n_graphs=1)


def rmat_batch(cfg: GNNConfig, n_nodes: int, avg_degree: int = 8,
               seed: int = 0, with_b2sr: Optional[bool] = None,
               device: DeviceLike = None) -> GraphBatch:
    """A power-law (R-MAT) full-graph batch: ``full_graph_batch`` over
    ``rmat_graph`` with the degree knob exposed."""
    return full_graph_batch(
        cfg, n_nodes, seed=seed, with_b2sr=with_b2sr, device=device,
        generator=partial(graph_gen.rmat_graph, avg_degree=avg_degree))
