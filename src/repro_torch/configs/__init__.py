"""Model configurations the port runs (its own copies: no import of the
reference's ``repro.configs``)."""

from repro_torch.configs.gnn import GNNConfig  # noqa: F401
