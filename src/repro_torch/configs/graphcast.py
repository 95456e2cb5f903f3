"""graphcast [arXiv:2212.12794]: encoder-processor-decoder mesh GNN.

16 processor layers, d 512, mesh refinement 6 (multimesh), 227 variables.
"""

from __future__ import annotations

import dataclasses

from repro_torch.configs.gnn import GNNConfig

CONFIG = GNNConfig(
    name="graphcast",
    family="graphcast",
    n_layers=16,
    d_hidden=512,
    aggregator="sum",
    mesh_refinement=6,
    n_vars=227,
    d_in=227,
    n_classes=227,  # the decoder predicts the variables back
)


def reduced() -> GNNConfig:
    """The same model at a test size (the reference's ``reduced``)."""
    return dataclasses.replace(CONFIG, name="graphcast-smoke", n_layers=2,
                               d_hidden=32, mesh_refinement=1, n_vars=8,
                               d_in=8, n_classes=8)
