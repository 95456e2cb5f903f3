"""GraphCast-style encode-process-decode mesh GNN [arXiv:2212.12794], the
port of ``repro.models.gnn.graphcast``.

Grid nodes (``n_vars`` features each) are encoded onto an icosahedral
multimesh (refinement r: 10·4^r + 2 nodes, Σ_l 60·4^l directed multimesh
edges), processed by ``n_layers`` interaction-network layers and decoded
back to the grid. The mesh topology is the reference's deterministic
synthetic one (:func:`build_mesh`: the same seeded numpy arrays; the
cardinalities of the real icosphere). Edges carry learned features, so
every aggregation is a valued ``index_add_``.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.gnn import GNNConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.gnn.common import _segment_sum, gather
from repro_torch.nn import MLP, Dense


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    g2m_senders: torch.Tensor      # grid -> mesh
    g2m_receivers: torch.Tensor
    mesh_senders: torch.Tensor     # mesh -> mesh (multimesh)
    mesh_receivers: torch.Tensor
    m2g_senders: torch.Tensor      # mesh -> grid
    m2g_receivers: torch.Tensor
    n_mesh: int


def mesh_sizes(refinement: int) -> Tuple[int, int]:
    """``(mesh nodes, multimesh edges)`` at ``refinement``."""
    n_mesh = 10 * 4 ** refinement + 2
    n_medges = sum(60 * 4 ** lvl for lvl in range(refinement + 1))
    return n_mesh, n_medges


def build_mesh(n_grid: int, refinement: int, seed: int = 0,
               device: DeviceLike = None) -> MeshSpec:
    """The reference's synthetic multimesh (same draws, same order), its
    index arrays as int64 on ``device`` (None = CUDA)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    n_mesh, n_medges = mesh_sizes(refinement)
    g2m_s = np.arange(n_grid, dtype=np.int32)
    g2m_r = (g2m_s % n_mesh).astype(np.int32)
    mesh_s = rng.integers(0, n_mesh, n_medges).astype(np.int32)
    mesh_r = ((mesh_s + 1 + rng.integers(0, max(n_mesh - 1, 1), n_medges))
              % n_mesh).astype(np.int32)
    m2g_r = np.repeat(np.arange(n_grid, dtype=np.int32), 3)
    m2g_s = rng.integers(0, n_mesh, 3 * n_grid).astype(np.int32)

    def idx(a):
        return torch.as_tensor(a.astype(np.int64), device=dev)

    return MeshSpec(g2m_senders=idx(g2m_s), g2m_receivers=idx(g2m_r),
                    mesh_senders=idx(mesh_s), mesh_receivers=idx(mesh_r),
                    m2g_senders=idx(m2g_s), m2g_receivers=idx(m2g_r),
                    n_mesh=n_mesh)


class InteractionLayer(nn.Module):
    def __init__(self, d: int):
        super().__init__()
        self.edge_mlp = MLP([3 * d, d, d], act=F.silu)
        self.node_mlp = MLP([2 * d, d, d], act=F.silu)

    def forward(self, h_nodes, senders, receivers, e, n: int):
        inp = torch.cat([gather(h_nodes, senders),
                         gather(h_nodes, receivers), e], -1)
        e_new = e + self.edge_mlp(inp)
        agg = _segment_sum(e_new, receivers, n)
        h_new = h_nodes + self.node_mlp(torch.cat([h_nodes, agg], -1))
        return h_new, e_new


class GraphCast(nn.Module):
    """``grid_encoder``, ``mesh_embed``, ``g2m_edge``, ``n_layers``
    interaction layers (``layers``), ``m2g_edge`` and ``grid_decoder``."""

    def __init__(self, cfg: GNNConfig):
        super().__init__()
        self.cfg = cfg
        d = cfg.d_hidden
        self.grid_encoder = MLP([cfg.d_in, d, d], act=F.silu)
        self.mesh_embed = Dense(d, d)
        self.g2m_edge = MLP([2 * d, d, d], act=F.silu)
        self.layers = nn.ModuleList(InteractionLayer(d)
                                    for _ in range(cfg.n_layers))
        self.m2g_edge = MLP([2 * d, d, d], act=F.silu)
        self.grid_decoder = MLP([2 * d, d, cfg.n_classes], act=F.silu)

    def forward(self, grid_feat: torch.Tensor,
                mesh: MeshSpec) -> torch.Tensor:
        d = self.cfg.d_hidden
        n_grid = grid_feat.shape[0]
        hg = self.grid_encoder(grid_feat)

        # encode: grid -> mesh
        inp = torch.cat([gather(hg, mesh.g2m_senders),
                         hg.new_zeros((mesh.g2m_senders.shape[0], d))], -1)
        hm = _segment_sum(self.g2m_edge(inp), mesh.g2m_receivers,
                          mesh.n_mesh)
        hm = self.mesh_embed(hm)

        # process: multimesh interaction layers
        e = hm.new_zeros((mesh.mesh_senders.shape[0], d))
        for layer in self.layers:
            hm, e = layer(hm, mesh.mesh_senders, mesh.mesh_receivers, e,
                          mesh.n_mesh)

        # decode: mesh -> grid
        inp = torch.cat([gather(hm, mesh.m2g_senders),
                         gather(hg, mesh.m2g_receivers)], -1)
        agg = _segment_sum(self.m2g_edge(inp), mesh.m2g_receivers, n_grid)
        return self.grid_decoder(torch.cat([hg, agg], -1))


def loss_fn(model: GraphCast, grid_feat: torch.Tensor, target: torch.Tensor,
            mesh: MeshSpec):
    """``(loss, {"mse": loss})``, the mean squared error of the forward."""
    loss = (model(grid_feat, mesh) - target).square().mean()
    return loss, {"mse": loss}
