"""Graph neural networks: the GCN over a B2SR adjacency."""
