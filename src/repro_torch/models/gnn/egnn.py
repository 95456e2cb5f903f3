"""EGNN [Satorras et al. arXiv:2102.09844], the port of
``repro.models.gnn.egnn``: E(n)-equivariant message passing.

m_ij = φ_e([h_i, h_j, ‖x_i − x_j‖²])
x_i' = x_i + (1/deg_i) Σ_j (x_i − x_j) · φ_x(m_ij)
h_i' = h_i + φ_h([h_i, Σ_j m_ij])

The messages depend on continuous pairwise distances, so they are
valued: gathers and ``index_add_`` over the edge list, as the reference
computes them outside any Pallas kernel.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.gnn import GNNConfig
from repro_torch.models.gnn.common import (GraphBatch, _segment_sum,
                                           gather, graph_ce_loss,
                                           graph_pool, node_ce_loss,
                                           segment_agg)
from repro_torch.nn import MLP, Dense


class EGNNLayer(nn.Module):
    def __init__(self, d: int):
        super().__init__()
        self.phi_e = MLP([2 * d + 1, d, d], act=F.silu, final_act=True)
        self.phi_x = MLP([d, d, 1], act=F.silu)
        self.phi_h = MLP([2 * d, d, d], act=F.silu)

    def forward(self, h, x, batch: GraphBatch, deg):
        n = h.shape[0]
        snd, rcv, msk = batch.senders, batch.receivers, batch.edge_mask
        dx = gather(x, rcv) - gather(x, snd)                  # x_i − x_j
        d2 = (dx * dx).sum(-1, keepdim=True)
        m = self.phi_e(torch.cat([gather(h, rcv), gather(h, snd), d2], -1))
        coord_msg = dx * self.phi_x(m)                        # [E, 3]
        x = x + segment_agg(coord_msg, rcv, n, msk) / deg[:, None]
        m_agg = segment_agg(m, rcv, n, msk)
        h = h + self.phi_h(torch.cat([h, m_agg], -1))
        return h, x


class EGNN(nn.Module):
    """``embed``, ``n_layers`` layers (``layers``) and the ``head`` (read
    by :func:`loss_fn`; ``forward`` returns the node states and the
    coordinates, as the reference's does)."""

    def __init__(self, cfg: GNNConfig):
        super().__init__()
        self.cfg = cfg
        self.embed = Dense(cfg.d_in, cfg.d_hidden)
        self.layers = nn.ModuleList(EGNNLayer(cfg.d_hidden)
                                    for _ in range(cfg.n_layers))
        self.head = Dense(cfg.d_hidden, cfg.n_classes)

    def forward(self, batch: GraphBatch) -> Tuple[torch.Tensor, torch.Tensor]:
        if batch.coords is None:
            raise ValueError("EGNN needs coordinates (batch.coords)")
        n = batch.node_feat.shape[0]
        h = self.embed(batch.node_feat)
        x = batch.coords
        deg = _segment_sum(batch.edge_mask.to(h.dtype), batch.receivers,
                           n).clamp_min(1.0)
        for layer in self.layers:
            h, x = layer(h, x, batch, deg)
        return h, x


def loss_fn(model: EGNN, batch: GraphBatch):
    """``(loss, {"ce": loss})``: the head over the node states (masked
    node cross-entropy) or, with ``n_graphs > 1``, over their per-graph
    mean."""
    h, _ = model(batch)
    if batch.n_graphs > 1:
        pooled = graph_pool(h, batch.graph_ids, batch.n_graphs,
                            batch.node_mask)
        loss = graph_ce_loss(model.head(pooled), batch.labels)
    else:
        loss = node_ce_loss(model.head(h), batch.labels, batch.train_mask)
    return loss, {"ce": loss}
