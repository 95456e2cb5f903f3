"""Shared GNN pieces: the full-graph batch the GCN reads and trains on,
the segment sum of messages over an edge list (the float baseline) and
the masked node cross-entropy."""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core.graphblas import GraphMatrix


@dataclasses.dataclass(frozen=True)
class GraphBatch:
    """A graph with node features: the fields of the reference's
    ``GraphBatch`` that the GCN forward and its loss read, with a port
    :class:`GraphMatrix` (rows = receivers) in place of its ELL view.
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
    n_graphs: int = 1


def segment_agg(messages: torch.Tensor, receivers: torch.Tensor,
                n_nodes: int, edge_mask: torch.Tensor) -> torch.Tensor:
    """Σ_j m_ij grouped by receiver, padding edges masked out (the
    reference's ``"sum"`` aggregator, the one the GCN uses)."""
    m = torch.where(edge_mask[:, None], messages, 0)
    return torch.zeros((n_nodes,) + m.shape[1:], dtype=m.dtype,
                       device=m.device).index_add_(0, receivers, m)


def node_ce_loss(logits: torch.Tensor, labels: torch.Tensor,
                 mask: torch.Tensor) -> torch.Tensor:
    """Mean of ``logsumexp − gold`` over the nodes in ``mask`` (divided by
    ``max(Σ mask, 1)``), computed as the reference's ``node_ce_loss``."""
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, labels.long()[:, None])[:, 0]
    per = logz - gold
    return (torch.where(mask, per, 0).sum()
            / mask.sum().clamp_min(1).to(per.dtype))
