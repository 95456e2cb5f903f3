"""gatedgcn [arXiv:2003.00982]: 16 layers, d 70, gated edge aggregation."""

from __future__ import annotations

import dataclasses

from repro_torch.configs.gnn import GNNConfig

CONFIG = GNNConfig(
    name="gatedgcn",
    family="gatedgcn",
    n_layers=16,
    d_hidden=70,
    aggregator="gated",
    d_in=128,
    n_classes=16,
)


def reduced() -> GNNConfig:
    """The same model at a test size (the reference's ``reduced``)."""
    return dataclasses.replace(CONFIG, name="gatedgcn-smoke", n_layers=2,
                               d_hidden=16, d_in=8, n_classes=4)
