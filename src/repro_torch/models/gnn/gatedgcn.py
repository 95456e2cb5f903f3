"""GatedGCN [Bresson & Laurent; Dwivedi et al. arXiv:2003.00982], the
port of ``repro.models.gnn.gatedgcn``.

h_i' = h_i + ReLU(Norm(U h_i + Σ_j η_ij ⊙ V h_j)),
η_ij = σ(ê_ij) / (Σ_j' σ(ê_ij') + ε),
ê_ij = e_ij + ReLU(Norm(A h_i + B h_j + C e_ij)).

The edge gates are per-edge floats, so the aggregation is valued: it is a
gather and an ``index_add_`` over the edge list, as the reference's is
outside any Pallas kernel (B2SR holds only the structure). Norm is
LayerNorm, the reference's stateless stand-in for the benchmark's
BatchNorm.

With ``cfg.shardmap_agg_axes`` the aggregation is receiver-partitioned
over a :class:`~repro_torch.core.mesh.ShardMesh` (the reference's
``shard_map`` path; DESIGN.md §8b). The data contract is the
reference's: the edge arrays are receiver-sorted and padded per block
(``data.graphs.partition_edges_by_receiver_block``), so edge chunk ``p``
holds exactly the edges whose receivers fall in node block ``p``. Slot
``p`` receives the whole ``h`` in ``cfg.message_dtype`` (the all-gather),
computes its chunk of edges and scatter-adds into its own node block with
``clip(rcv − p·n_local)``; the blocks are concatenated in node order on
the first slot (single-controller, as the sharded registry rows are). The
dense path runs where the reference's does: no mesh axis among the
config's, or ``n`` not a multiple of the slot count. ``cfg.remat``
recomputes each layer in the backward
(``torch.utils.checkpoint.checkpoint(use_reentrant=False)``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call

from repro_torch.configs.gnn import GNNConfig
from repro_torch.core import partition as partition_mod
from repro_torch.core.mesh import ShardMesh, make_mesh
from repro_torch.models.gnn.common import (GraphBatch, _segment_sum,
                                           gather, graph_ce_loss,
                                           graph_pool, node_ce_loss)
from repro_torch.nn import Dense, LayerNorm, remat

_MSG_DTYPES = {"float32": None, "bfloat16": torch.bfloat16}


class GatedGCNLayer(nn.Module):
    def __init__(self, d: int):
        super().__init__()
        for name in ("U", "V", "A", "B", "C"):
            self.add_module(name, Dense(d, d))
        self.norm_h = LayerNorm(d)
        self.norm_e = LayerNorm(d)

    def agg_dense(self, h, e, batch: GraphBatch):
        """The gather/scatter aggregation over the whole edge list."""
        n = h.shape[0]
        hs = gather(h, batch.senders)
        e_hat, sig = _edges(self, hs, gather(h, batch.receivers), e,
                            batch.edge_mask)
        denom = _segment_sum(sig, batch.receivers, n)
        agg = _segment_sum(sig * self.V(hs), batch.receivers, n)
        return e_hat, agg, denom

    def agg_sharded(self, h, e, batch: GraphBatch, slots, msg_dtype):
        """The receiver-partitioned aggregation over ``slots`` (see the
        module doc); the blocks of ``ê``, ``agg`` and ``denom`` come back
        concatenated on ``h``'s device."""
        n, n_p = h.shape[0], len(slots)
        n_local, e_local = n // n_p, batch.senders.shape[0] // n_p
        home = h.device
        e_hats, aggs, denoms = [], [], []
        for p, dev in enumerate(slots):
            es = slice(p * e_local, (p + 1) * e_local)
            # the layer's parameters replicated to the slot (no copy on
            # the home device; the copies stay in the autograd graph)
            lp = self if _same(dev, home) else _Replica(self, dev)
            h_full = h.to(dev, msg_dtype or h.dtype)
            snd, rcv = batch.senders[es].to(dev), batch.receivers[es].to(dev)
            hs = gather(h_full, snd)
            e_hat, sig = _edges(lp, hs, gather(h_full, rcv), e[es].to(dev),
                                batch.edge_mask[es].to(dev))
            r_local = (rcv - p * n_local).clamp(0, n_local - 1)
            sig32 = sig.float()
            denom = _segment_sum(sig32, r_local, n_local)
            agg = _segment_sum(sig32 * lp.V(hs).float(), r_local, n_local)
            e_hats.append(e_hat.to(home))
            aggs.append(agg.to(home, h.dtype))
            denoms.append(denom.to(home, h.dtype))
        return torch.cat(e_hats), torch.cat(aggs), torch.cat(denoms)

    def forward(self, h, e, batch: GraphBatch, slots=None, msg_dtype=None):
        if slots is not None:
            e_hat, agg, denom = self.agg_sharded(h, e, batch, slots,
                                                 msg_dtype)
        else:
            e_hat, agg, denom = self.agg_dense(h, e, batch)
        eta_agg = agg / denom.clamp_min(1e-6)
        h = h + F.relu(self.norm_h(self.U(h) + eta_agg))
        return h, e_hat


def _same(dev: torch.device, home: torch.device) -> bool:
    """``dev`` names ``home`` (a CUDA slot without an index names the
    current card)."""
    dev = torch.device(dev)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev == home


def _edges(lp, h_snd, h_rcv, e, msk):
    """``(ê, σ(ê)·mask)`` of the given edges under ``lp``'s weights."""
    e_hat = e + F.relu(lp.norm_e(
        (lp.A(h_rcv) + lp.B(h_snd)).to(e.dtype) + lp.C(e)))
    return e_hat, torch.sigmoid(e_hat) * msk[:, None]


class _Replica:
    """The sublayers ``A, B, C, V, norm_e`` of a layer over copies of
    their parameters on ``dev``."""

    def __init__(self, layer: GatedGCNLayer, dev: torch.device):
        for name in ("A", "B", "C", "V", "norm_e"):
            mod = getattr(layer, name)
            params = {k: v.to(dev) for k, v in mod.named_parameters()}
            setattr(self, name,
                    lambda x, mod=mod, params=params:
                    functional_call(mod, params, (x,)))


class GatedGCN(nn.Module):
    """Embeddings of nodes (``embed_h``) and edges (``embed_e``), ``n_layers``
    gated layers (``layers``) and the ``head``. ``mesh`` (a
    :class:`ShardMesh`) is used when ``cfg.shardmap_agg_axes`` is set;
    ``None`` means every visible CUDA device on the first axis, built at
    the first sharded call (never the CPU unless the caller's mesh lists
    it)."""

    def __init__(self, cfg: GNNConfig, mesh: Optional[ShardMesh] = None):
        super().__init__()
        self.cfg, self.mesh = cfg, mesh
        self.embed_h = Dense(cfg.d_in, cfg.d_hidden)
        self.embed_e = Dense(1, cfg.d_hidden)
        self.layers = nn.ModuleList(GatedGCNLayer(cfg.d_hidden)
                                    for _ in range(cfg.n_layers))
        self.head = Dense(cfg.d_hidden, cfg.n_classes)

    def slots(self, n: int) -> Optional[Tuple[torch.device, ...]]:
        """The slots of the receiver-partitioned aggregation, or None for
        the dense path (no axis of the config on the mesh, or ``n`` not a
        multiple of the slot count)."""
        want = tuple(self.cfg.shardmap_agg_axes)
        if not want:
            return None
        if self.mesh is None:
            self.mesh = make_mesh((-1,) + (1,) * (len(want) - 1), want)
        axes = tuple(a for a in want if a in self.mesh.axis_names)
        if not axes:
            return None
        if n % partition_mod.shard_count(self.mesh, axes):
            return None
        return partition_mod.shard_devices(self.mesh, axes)

    def forward(self, batch: GraphBatch, pooled: bool = False):
        cfg = self.cfg
        h = self.embed_h(batch.node_feat)
        if batch.edge_feat is not None:
            e = self.embed_e(batch.edge_feat)
        else:
            e = h.new_zeros((batch.senders.shape[0], cfg.d_hidden))
        slots = self.slots(h.shape[0])
        if slots is not None and batch.senders.shape[0] % len(slots):
            raise ValueError(
                f"{batch.senders.shape[0]} edges do not split over "
                f"{len(slots)} slots: the sharded aggregation needs the "
                "edges receiver-sorted and padded per block "
                "(partition_edges_by_receiver_block)")
        msg_dtype = _MSG_DTYPES[cfg.message_dtype]
        for layer in self.layers:
            if cfg.remat:
                h, e = remat(layer, h, e, extra=(batch, slots, msg_dtype))
            else:
                h, e = layer(h, e, batch, slots, msg_dtype)
        if pooled:
            h = graph_pool(h, batch.graph_ids, batch.n_graphs,
                           batch.node_mask)
        return self.head(h)


def loss_fn(model: GatedGCN, batch: GraphBatch):
    """``(loss, {"ce": loss})``: the masked node cross-entropy, or with
    ``n_graphs > 1`` the cross-entropy of the head over the mean-pooled
    node states."""
    if batch.n_graphs > 1:  # graph-level task (molecule shape)
        loss = graph_ce_loss(model(batch, pooled=True), batch.labels)
    else:
        loss = node_ce_loss(model(batch), batch.labels, batch.train_mask)
    return loss, {"ce": loss}
