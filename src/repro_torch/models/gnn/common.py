"""Shared GNN pieces, the port of ``repro.models.gnn.common``: the graph
batch (one graph, a padded sampled subgraph or a disjoint union of small
graphs), the segment aggregation of messages over an edge list, the
disjoint-union batching, graph pooling and the masked node
cross-entropy."""

from __future__ import annotations

import dataclasses
from typing import List, Mapping, Optional

import numpy as np
import torch

from repro_torch.core.graphblas import GraphMatrix
from repro_torch.device import DeviceLike, resolve_device


@dataclasses.dataclass(frozen=True)
class GraphBatch:
    """A graph with node features: the reference's ``GraphBatch`` with a
    port :class:`GraphMatrix` (rows = receivers) in place of its ELL view.
    The training fields default to None (``n_graphs`` to 1), so inference
    batches need not carry them."""

    node_feat: torch.Tensor                # [N, d_in]
    senders: torch.Tensor                  # [E] int64
    receivers: torch.Tensor                # [E] int64
    edge_mask: torch.Tensor                # [E] bool
    graph: Optional[GraphMatrix] = None    # B2SR adjacency (paper technique)
    degrees: Optional[torch.Tensor] = None  # [N] float (self loop included)
    labels: Optional[torch.Tensor] = None      # [N] int64 (or [G])
    train_mask: Optional[torch.Tensor] = None  # [N] bool: nodes in the loss
    node_mask: Optional[torch.Tensor] = None   # [N] bool (padding False)
    graph_ids: Optional[torch.Tensor] = None   # [N] int64 (pooling)
    coords: Optional[torch.Tensor] = None      # [N, 3] float (egnn)
    edge_feat: Optional[torch.Tensor] = None   # [E, d_e] float
    n_graphs: int = 1


def gather(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[idx]`` along the first axis, through ``index_select``: its
    gradient is an ``index_add_``, where that of ``x[idx]`` on the card
    sorts the indices and walks each one's repeats in a single warp, so
    an edge list with a hub or padding edges (all from node 0) spends
    seconds there (on an H100, a GatedGCN step on R-MAT scale 16 took
    10.7 s, 92% of it in that backward)."""
    return x.index_select(0, idx)


def _segment_sum(x: torch.Tensor, idx: torch.Tensor,
                 n: int) -> torch.Tensor:
    return torch.zeros((n,) + x.shape[1:], dtype=x.dtype,
                       device=x.device).index_add_(0, idx, x)


def segment_agg(messages: torch.Tensor, receivers: torch.Tensor,
                n_nodes: int, edge_mask: torch.Tensor,
                aggregator: str = "sum") -> torch.Tensor:
    """⊕_j m_ij grouped by receiver, padding edges masked out.

    ``"sum"``; ``"mean"`` (the sum over ``max(count, 1)`` unmasked
    edges); ``"max"``: masked messages enter at −inf and a node with no
    unmasked edge gets 0 (any non-finite maximum becomes 0, as in the
    reference). ``"max"`` is ``scatter_reduce("amax")``, whose gradient
    is split evenly among the messages tied at a node's maximum.
    """
    mask = edge_mask[:, None]
    if aggregator in ("sum", "mean"):
        s = _segment_sum(torch.where(mask, messages, 0), receivers, n_nodes)
        if aggregator == "sum":
            return s
        cnt = _segment_sum(edge_mask.to(s.dtype), receivers, n_nodes)
        return s / cnt.clamp_min(1.0)[:, None]
    if aggregator == "max":
        neg = torch.where(mask, messages, -torch.inf)
        idx = receivers.view((-1,) + (1,) * (neg.dim() - 1)).expand_as(neg)
        out = torch.full((n_nodes,) + neg.shape[1:], -torch.inf,
                         dtype=neg.dtype, device=neg.device).scatter_reduce(
            0, idx, neg, "amax", include_self=True)
        return torch.where(torch.isfinite(out), out, 0.0)
    raise ValueError(aggregator)


def batch_graphs(graphs: List[Mapping[str, np.ndarray]],
                 device: DeviceLike = None) -> GraphBatch:
    """Disjoint-union batching of small graphs (the molecule shape): each
    a dict of numpy ``node_feat``, ``senders``, ``receivers``, ``label``
    and optionally ``coords``; one ``graph_ids`` entry per node."""
    dev = resolve_device(device)
    n_off = 0
    feats, snd, rcv, gids, labels, coords = [], [], [], [], [], []
    for gi, g in enumerate(graphs):
        feats.append(g["node_feat"])
        snd.append(np.asarray(g["senders"]) + n_off)
        rcv.append(np.asarray(g["receivers"]) + n_off)
        gids.append(np.full(g["node_feat"].shape[0], gi, np.int64))
        labels.append(g["label"])
        if "coords" in g:
            coords.append(g["coords"])
        n_off += g["node_feat"].shape[0]
    n = n_off
    e = sum(len(s) for s in snd)

    def tensor(a, dtype=None):
        return torch.as_tensor(np.asarray(a, dtype=dtype), device=dev)

    return GraphBatch(
        node_feat=tensor(np.concatenate(feats)),
        senders=tensor(np.concatenate(snd), np.int64),
        receivers=tensor(np.concatenate(rcv), np.int64),
        edge_mask=torch.ones(e, dtype=torch.bool, device=dev),
        labels=tensor(labels, np.int64),
        train_mask=torch.ones(n, dtype=torch.bool, device=dev),
        node_mask=torch.ones(n, dtype=torch.bool, device=dev),
        graph_ids=tensor(np.concatenate(gids)),
        coords=tensor(np.concatenate(coords)) if coords else None,
        n_graphs=len(graphs))


def graph_pool(h: torch.Tensor, graph_ids: torch.Tensor, n_graphs: int,
               node_mask: torch.Tensor, how: str = "mean") -> torch.Tensor:
    """Per-graph ``"sum"`` or ``"mean"`` (over ``max(count, 1)`` unmasked
    nodes) of ``h``, padding nodes masked out: ``[n_graphs, d]``."""
    s = _segment_sum(torch.where(node_mask[:, None], h, 0), graph_ids,
                     n_graphs)
    if how == "sum":
        return s
    cnt = _segment_sum(node_mask.to(h.dtype), graph_ids, n_graphs)
    return s / cnt.clamp_min(1.0)[:, None]


def graph_ce_loss(logits: torch.Tensor,
                  labels: torch.Tensor) -> torch.Tensor:
    """Mean of ``logsumexp − gold`` over graphs (the graph-level loss of
    every family, on pooled logits ``[G, C]``)."""
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, labels.long()[:, None])[:, 0]
    return (logz - gold).mean()


def node_ce_loss(logits: torch.Tensor, labels: torch.Tensor,
                 mask: torch.Tensor) -> torch.Tensor:
    """Mean of ``logsumexp − gold`` over the nodes in ``mask`` (divided by
    ``max(Σ mask, 1)``), computed as the reference's ``node_ce_loss``."""
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, labels.long()[:, None])[:, 0]
    per = logz - gold
    return (torch.where(mask, per, 0).sum()
            / mask.sum().clamp_min(1).to(per.dtype))
