"""The GNN configuration: the fields of the reference's
``repro.configs.base.GNNConfig`` that the GCN forward and its training
step read."""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class GNNConfig:
    name: str
    n_layers: int
    d_hidden: int
    aggregator: str = "sum"    # sum | mean (GCN reads only ``norm``)
    norm: str = "none"         # sym (D^-1/2 (A + I) D^-1/2) | none (mean)
    d_in: int = 128
    n_classes: int = 16
    # aggregate through the B2SR adjacency (GraphMatrix.mxm) rather than
    # the float segment sum over the edge list
    use_b2sr: bool = False
    tile_dim: int = 32
    # the model family ``training.train_steps`` builds a step for; the
    # port has the GCN only (the others: ROADMAP Queue 1 item 10)
    family: str = "gcn"
    # mesh axes the B2SR aggregation is row-sharded over
    # (``gnn_bit.layers.aggregate(axes=...)``, the sharded registry rows);
    # () aggregates on one device
    shardmap_agg_axes: tuple = ()
