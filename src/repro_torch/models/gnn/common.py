"""Shared GNN pieces: the full-graph batch the GCN reads and the segment
sum of messages over an edge list (the float baseline)."""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core.graphblas import GraphMatrix


@dataclasses.dataclass(frozen=True)
class GraphBatch:
    """A graph with node features: the fields of the reference's
    ``GraphBatch`` that the GCN forward reads, with a port
    :class:`GraphMatrix` (rows = receivers) in place of its ELL view."""

    node_feat: torch.Tensor                # [N, d_in]
    senders: torch.Tensor                  # [E] int64
    receivers: torch.Tensor                # [E] int64
    edge_mask: torch.Tensor                # [E] bool
    graph: Optional[GraphMatrix] = None    # B2SR adjacency (paper technique)
    degrees: Optional[torch.Tensor] = None  # [N] float (self loop included)


def segment_agg(messages: torch.Tensor, receivers: torch.Tensor,
                n_nodes: int, edge_mask: torch.Tensor) -> torch.Tensor:
    """Σ_j m_ij grouped by receiver, padding edges masked out (the
    reference's ``"sum"`` aggregator, the one the GCN uses)."""
    m = torch.where(edge_mask[:, None], messages, 0)
    return torch.zeros((n_nodes,) + m.shape[1:], dtype=m.dtype,
                       device=m.device).index_add_(0, receivers, m)
