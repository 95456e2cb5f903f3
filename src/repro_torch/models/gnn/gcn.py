"""GCN [Kipf & Welling]: h' = σ(Â h W), Â = D^-1/2 (A + I) D^-1/2.

The normalisation is refactored as Â·h = D^-1/2 · (A + I)·(D^-1/2 h), so
the inner product is over the binary adjacency and goes through
``gnn_bit.layers.aggregate`` (the registry's dense mxm row: the
``spmm_dense`` kernel on ``b2sr_cuda``; row-sharded over
``cfg.shardmap_agg_axes`` when set). With ``use_b2sr=False`` (or a
batch without a graph) the float segment sum over the edge list is the
baseline. The order of operations is the reference's (``forward`` and
``_aggregate`` of ``repro.models.gnn.gcn``): aggregate, then ``@ W + b``,
so the float results match it. :func:`loss_fn` is the reference's:
the masked node cross-entropy, or on a batch of several graphs
(``n_graphs > 1``, molecule batches) the mean cross-entropy of the
per-graph mean of the logits.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch
from torch import nn

from repro_torch.configs.gnn import GNNConfig
from repro_torch.gnn_bit import layers as bit_layers
from repro_torch.models.gnn.common import (GraphBatch, graph_ce_loss,
                                           graph_pool, node_ce_loss,
                                           segment_agg)


class GCN(nn.Module):
    """``n_layers`` of aggregate, ``@ W + b`` and ReLU (none after the
    last); layer ``i``'s weight is ``layers[i].weight`` ``[d_out, d_in]``
    (``nn.Linear``'s layout; the reference keeps ``w`` as ``[d_in,
    d_out]``, see ``repro_torch.convert.gcn_state_from_reference``)."""

    def __init__(self, cfg: GNNConfig):
        super().__init__()
        self.cfg = cfg
        dims = ([cfg.d_in] + [cfg.d_hidden] * (cfg.n_layers - 1)
                + [cfg.n_classes])
        self.layers = nn.ModuleList(nn.Linear(dims[i], dims[i + 1])
                                    for i in range(cfg.n_layers))

    def _aggregate(self, batch: GraphBatch, h: torch.Tensor) -> torch.Tensor:
        """Â·h with symmetric normalisation (or plain mean aggregation)."""
        cfg, n = self.cfg, h.shape[0]
        deg = batch.degrees
        if deg is None:
            deg = torch.zeros(n, dtype=h.dtype, device=h.device).index_add_(
                0, batch.receivers, batch.edge_mask.to(h.dtype)) + 1.0
        use_graph = cfg.use_b2sr and batch.graph is not None
        if cfg.norm == "sym":
            inv_sqrt = torch.rsqrt(deg.clamp_min(1.0))[:, None]
            h = h * inv_sqrt
        if use_graph:
            agg = bit_layers.aggregate(
                batch.graph, h, axes=tuple(cfg.shardmap_agg_axes)) + h
        else:
            agg = segment_agg(h[batch.senders], batch.receivers, n,
                              batch.edge_mask) + h
        if cfg.norm == "sym":
            return agg * inv_sqrt
        return agg / deg.clamp_min(1.0)[:, None]

    def forward(self, batch: GraphBatch) -> torch.Tensor:
        h = batch.node_feat
        for i, lin in enumerate(self.layers):
            h = self._aggregate(batch, h)
            h = h @ lin.weight.T + lin.bias
            if i < len(self.layers) - 1:
                h = torch.relu(h)
        return h


def loss_fn(model: Callable[[GraphBatch], torch.Tensor], batch: GraphBatch
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """``(loss, {"ce": loss})``: the masked node cross-entropy of
    ``model(batch)`` over ``batch.train_mask`` or, with ``n_graphs > 1``,
    the cross-entropy of ``graph_pool`` (mean) of the logits against the
    graphs' labels. ``model`` is a :class:`GCN` or any callable from a
    batch to logits."""
    logits = model(batch)
    if batch.n_graphs > 1:  # graph-level task (molecule shape)
        pooled = graph_pool(logits, batch.graph_ids, batch.n_graphs,
                            batch.node_mask)
        loss = graph_ce_loss(pooled, batch.labels)
    else:
        loss = node_ce_loss(logits, batch.labels, batch.train_mask)
    return loss, {"ce": loss}
