"""The GNN configuration, the port of ``repro.configs.base.GNNConfig``
(the same fields and defaults; ``family`` defaults to ``"gcn"``)."""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class GNNConfig:
    name: str
    n_layers: int
    d_hidden: int
    aggregator: str = "sum"    # sum | mean | max | gated (GCN reads ``norm``)
    norm: str = "none"         # sym (D^-1/2 (A + I) D^-1/2) | none (mean)
    d_in: int = 128
    n_classes: int = 16
    # egnn
    equivariance: Optional[str] = None   # "E(n)"
    # graphcast
    mesh_refinement: Optional[int] = None
    n_vars: Optional[int] = None
    # aggregate through the B2SR adjacency (GraphMatrix.mxm) rather than
    # the float segment sum over the edge list
    use_b2sr: bool = False
    tile_dim: int = 32
    dtype: str = "float32"
    # the model family: gcn | gatedgcn | egnn | graphcast
    family: str = "gcn"
    # mesh axes the aggregation is sharded over: the GCN's B2SR product
    # row-sharded (``gnn_bit.layers.aggregate(axes=...)``, the sharded
    # registry rows), GatedGCN's receiver-partitioned aggregation (each
    # slot owns a node block and the edges whose receivers land in it);
    # () aggregates on one device
    shardmap_agg_axes: tuple = ()
    # gather/message dtype of GatedGCN's sharded aggregation ("bfloat16"
    # rounds the gathered features; the products stay float32)
    message_dtype: str = "float32"
    # recompute each GatedGCN layer in the backward instead of saving it
    # (``torch.utils.checkpoint``)
    remat: bool = False
