"""egnn [arXiv:2102.09844]: 4 layers, d 64, E(n)-equivariant message
passing."""

from __future__ import annotations

import dataclasses

from repro_torch.configs.gnn import GNNConfig

CONFIG = GNNConfig(
    name="egnn",
    family="egnn",
    n_layers=4,
    d_hidden=64,
    aggregator="sum",
    equivariance="E(n)",
    d_in=16,
    n_classes=8,
)


def reduced() -> GNNConfig:
    """The same model at a test size (the reference's ``reduced``)."""
    return dataclasses.replace(CONFIG, name="egnn-smoke", n_layers=2,
                               d_hidden=16, d_in=4, n_classes=2)
