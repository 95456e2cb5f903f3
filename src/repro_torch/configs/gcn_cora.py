"""gcn-cora [arXiv:1609.02907]: 2 layers, d_hidden 16, symmetric norm.

The published Cora GCN: 1,433 bag-of-words features, 7 classes. With
``use_b2sr`` the aggregation Â·X runs as the binary SpMM
D^-1/2 (A · (D^-1/2 X)), the paper's technique on the GCN's hot path.
"""

from __future__ import annotations

import dataclasses

from repro_torch.configs.gnn import GNNConfig

CONFIG = GNNConfig(
    name="gcn-cora",
    family="gcn",
    n_layers=2,
    d_hidden=16,
    aggregator="mean",
    norm="sym",
    d_in=1433,
    n_classes=7,
    use_b2sr=True,
    tile_dim=32,
)


def reduced() -> GNNConfig:
    """The same model at a test size (the reference's ``reduced``)."""
    return dataclasses.replace(CONFIG, name="gcn-smoke", d_in=32,
                               n_classes=4)
