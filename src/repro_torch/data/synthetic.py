"""Synthetic token streams, GNN batches and DIN batches (numpy, seeded),
the port's twin of ``repro.data.synthetic``: ``lm_batch`` and
``TokenStream`` (the training data pipeline, with ``state`` and
``restore``), ``full_graph_batch``, ``rmat_batch``, ``minibatch_batch``
(the neighbour-sampled ``minibatch_lg`` shape), ``molecule_batch`` (a
disjoint union of small graphs, graph labels) and ``din_batch``.

The draws are the reference's, in its order, from one
``np.random.default_rng(seed)`` (the graph from the pattern's own seeded
generator, then the features, the labels, the masks, the coordinates),
so a seed gives the same arrays in both packages. A B2SR adjacency
(``with_b2sr``) is stored with the receivers as rows (``y[i] = Σ_{j → i}
x[j]``, the reference's ``coo_to_b2sr(cols, rows, …)``) and keeps its
transpose, which the dense ``mxm`` row's gradient walks. The B2SR is
binary: where a sampled or molecule edge list draws a (sender, receiver)
pair more than once, the repeats are masked out of ``edge_mask`` when the
batch carries a B2SR, so the edge-list path aggregates the same
adjacency (the reference builds no B2SR for these shapes; without
``with_b2sr`` the arrays are the reference's exactly). The full-graph
degrees are the receivers' in-edge counts plus one (the self loop).
"""

from __future__ import annotations

from functools import partial
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from repro_torch.configs.gnn import GNNConfig
from repro_torch.configs.lm import TransformerConfig
from repro_torch.configs.recsys import DINConfig
from repro_torch.core.graphblas import GraphMatrix
from repro_torch.data import graphs as graph_gen
from repro_torch.data.neighbor_sampler import sample
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.gnn.common import GraphBatch
from repro_torch.models.recsys.din import DINBatch


# ---------------------------------------------------------------------------
# LM token streams
# ---------------------------------------------------------------------------

def lm_batch(cfg: TransformerConfig, batch: int, seq: int, seed: int = 0,
             device: DeviceLike = None):
    """``(tokens, labels)`` int32 ``[batch, seq]`` on ``device``: one
    ``[batch, seq + 1]`` draw of ``default_rng(seed)``, shifted by one."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (batch, seq + 1), dtype=np.int32)
    return (torch.from_numpy(tokens[:, :-1].copy()).to(dev),
            torch.from_numpy(tokens[:, 1:].copy()).to(dev))


class TokenStream:
    """Infinite deterministic token stream (the data pipeline for
    training): batch ``i`` is ``lm_batch`` of seed ``seed + i``."""

    def __init__(self, cfg: TransformerConfig, batch: int, seq: int,
                 seed: int = 0, device: DeviceLike = None):
        self.cfg, self.batch, self.seq, self.seed = cfg, batch, seq, seed
        self.device = resolve_device(device)
        self.step = 0

    def __iter__(self):
        return self

    def __next__(self):
        out = lm_batch(self.cfg, self.batch, self.seq,
                       seed=self.seed + self.step, device=self.device)
        self.step += 1
        return out

    def state(self):
        return {"step": self.step, "seed": self.seed}

    def restore(self, state):
        self.step = int(state["step"])
        self.seed = int(state["seed"])


# ---------------------------------------------------------------------------
# GNN batches
# ---------------------------------------------------------------------------

def full_graph_batch(cfg: GNNConfig, n_nodes: int, pattern: str = "hybrid",
                     seed: int = 0, with_b2sr: Optional[bool] = None,
                     generator: Optional[Callable] = None,
                     device: DeviceLike = None,
                     coords: bool = False) -> GraphBatch:
    """One graph of ``n_nodes`` nodes with node features, labels, a 30%
    train mask and, with ``coords``, 3-d coordinates (egnn), on
    ``device`` (None = CUDA). ``generator(n, seed=)`` takes
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
    xyz = (rng.standard_normal((n_nodes, 3)).astype(np.float32)
           if coords else None)
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
        coords=None if xyz is None else tensor(xyz),
        n_graphs=1)


def rmat_batch(cfg: GNNConfig, n_nodes: int, avg_degree: int = 8,
               seed: int = 0, with_b2sr: Optional[bool] = None,
               device: DeviceLike = None,
               coords: bool = False) -> GraphBatch:
    """A power-law (R-MAT) full-graph batch: ``full_graph_batch`` over
    ``rmat_graph`` with the degree knob exposed."""
    return full_graph_batch(
        cfg, n_nodes, seed=seed, with_b2sr=with_b2sr, device=device,
        coords=coords,
        generator=partial(graph_gen.rmat_graph, avg_degree=avg_degree))


def _edge_list_graph(cfg: GNNConfig, snd: np.ndarray, rcv: np.ndarray,
                     mask: np.ndarray, n: int, with_b2sr: Optional[bool],
                     dev: torch.device):
    """``(graph, mask)``: with B2SR (``with_b2sr``, default
    ``cfg.use_b2sr``) the adjacency of the unmasked edges on
    ``b2sr_cuda`` and ``mask`` with each repeated pair's later copies
    masked out; else ``(None, mask)``."""
    if not (cfg.use_b2sr if with_b2sr is None else with_b2sr):
        return None, mask
    key = np.where(mask, rcv.astype(np.int64) * n + snd, -1)
    _, first = np.unique(key, return_index=True)
    keep = np.zeros_like(mask)
    keep[first] = True
    mask = mask & keep
    graph = GraphMatrix.from_coo(rcv[mask], snd[mask], n, n, cfg.tile_dim,
                                 backend="b2sr_cuda", device=dev)
    return graph, mask


def minibatch_batch(cfg: GNNConfig, n_total: int, batch_nodes: int,
                    fanout: Sequence[int] = (15, 10), seed: int = 0,
                    coords: bool = False, with_b2sr: Optional[bool] = None,
                    device: DeviceLike = None) -> GraphBatch:
    """A neighbour-sampled subgraph (the real sampler) of a dot graph of
    ``n_total`` nodes at density ``min(20/n, 0.01)``: ``batch_nodes``
    seeds (the loss nodes) and ``fanout`` hops, padded to the static
    ``sampled_sizes``."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    rows, cols = graph_gen.dot_graph(
        n_total, density=min(20.0 / n_total, 0.01), seed=seed)
    order = np.argsort(rows)
    rows_s, cols_s = rows[order], cols[order]
    row_ptr = np.zeros(n_total + 1, np.int64)
    np.add.at(row_ptr, rows_s + 1, 1)
    row_ptr = np.cumsum(row_ptr)
    seeds = rng.choice(n_total, size=batch_nodes, replace=False)
    sub = sample(row_ptr, cols_s, seeds, fanout, seed=seed)
    n_pad = sub.node_ids.shape[0]
    feat = rng.standard_normal((n_pad, cfg.d_in)).astype(np.float32)
    labels = rng.integers(0, cfg.n_classes, n_pad, dtype=np.int32)
    xyz = (rng.standard_normal((n_pad, 3)).astype(np.float32)
           if coords else None)
    graph, emask = _edge_list_graph(cfg, sub.senders, sub.receivers,
                                    sub.edge_mask, n_pad, with_b2sr, dev)

    def tensor(a, dtype=None):
        return torch.as_tensor(np.asarray(a, dtype=dtype), device=dev)

    return GraphBatch(
        node_feat=tensor(feat),
        senders=tensor(sub.senders, np.int64),
        receivers=tensor(sub.receivers, np.int64),
        edge_mask=tensor(emask),
        graph=graph,
        labels=tensor(labels, np.int64),
        train_mask=tensor(sub.seed_mask),
        node_mask=tensor(sub.node_mask),
        graph_ids=torch.zeros(n_pad, dtype=torch.int64, device=dev),
        coords=None if xyz is None else tensor(xyz),
        n_graphs=1)


def molecule_batch(cfg: GNNConfig, n_graphs: int, nodes_per: int = 30,
                   edges_per: int = 64, seed: int = 0,
                   with_b2sr: Optional[bool] = None,
                   device: DeviceLike = None) -> GraphBatch:
    """``n_graphs`` random graphs of ``nodes_per`` nodes and ``edges_per``
    directed edges each (pairs drawn uniformly, repeats and self loops
    included), one label per graph, with coordinates."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    n, e = n_graphs * nodes_per, n_graphs * edges_per
    feat = rng.standard_normal((n, cfg.d_in)).astype(np.float32)
    offs = np.repeat(np.arange(n_graphs) * nodes_per, edges_per)
    snd = rng.integers(0, nodes_per, e) + offs
    rcv = rng.integers(0, nodes_per, e) + offs
    labels = rng.integers(0, cfg.n_classes, n_graphs, dtype=np.int32)
    xyz = rng.standard_normal((n, 3)).astype(np.float32)
    graph, emask = _edge_list_graph(cfg, snd, rcv, np.ones(e, bool), n,
                                    with_b2sr, dev)

    def tensor(a, dtype=None):
        return torch.as_tensor(np.asarray(a, dtype=dtype), device=dev)

    return GraphBatch(
        node_feat=tensor(feat),
        senders=tensor(snd, np.int64),
        receivers=tensor(rcv, np.int64),
        edge_mask=tensor(emask),
        graph=graph,
        labels=tensor(labels, np.int64),
        train_mask=torch.ones(n, dtype=torch.bool, device=dev),
        node_mask=torch.ones(n, dtype=torch.bool, device=dev),
        graph_ids=tensor(np.repeat(np.arange(n_graphs), nodes_per),
                         np.int64),
        coords=tensor(xyz),
        n_graphs=n_graphs)


# ---------------------------------------------------------------------------
# DIN batches
# ---------------------------------------------------------------------------

def din_batch(cfg: DINConfig, batch: int, seed: int = 0,
              device: DeviceLike = None) -> DINBatch:
    """A DIN batch of ``batch`` samples on ``device``: history lengths
    uniform in ``[1, seq_len]``, ids uniform over each vocabulary, 0/1
    labels; ids int32, the mask bool, the labels float32."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    L = cfg.seq_len
    lens = rng.integers(1, L + 1, batch)
    mask = np.arange(L)[None, :] < lens[:, None]

    def ids(high, shape):
        return torch.from_numpy(rng.integers(0, high, shape, dtype=np.int32)
                                ).to(dev)

    hist_items = ids(cfg.n_items, (batch, L))
    hist_cates = ids(cfg.n_cates, (batch, L))
    hist_mask = torch.from_numpy(mask).to(dev)
    target_item = ids(cfg.n_items, batch)
    target_cate = ids(cfg.n_cates, batch)
    user_feats = ids(cfg.user_feat_vocab, (batch, cfg.n_user_feats))
    labels = torch.from_numpy(rng.integers(0, 2, batch).astype(np.float32)
                              ).to(dev)
    return DINBatch(hist_items, hist_cates, hist_mask, target_item,
                    target_cate, user_feats, labels)
