"""Graph algorithms over GraphMatrix (paper §V)."""

from repro_torch.algorithms.bfs import BFSResult, bfs  # noqa: F401
