"""Graph algorithms over GraphMatrix (paper §V)."""

from repro_torch.algorithms.bfs import BFSResult, bfs  # noqa: F401
from repro_torch.algorithms.cc import CCResult, connected_components  # noqa: F401
from repro_torch.algorithms.khop import (KHopResult, khop_frontier,  # noqa: F401
                                         khop_reachability)
from repro_torch.algorithms.pagerank import PageRankResult, pagerank, ppr  # noqa: F401
from repro_torch.algorithms.sssp import SSSPResult, sssp  # noqa: F401
from repro_torch.algorithms.tc import triangle_count  # noqa: F401
