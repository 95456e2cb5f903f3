"""Launch-plan cache for the batched query engine.

A *plan* is a batched query loop specialised to one (graph, kernel,
batch width) combination: the reference jit-compiles it, and PyTorch has
no ``jit`` to cache, so here a plan is a Python closure over the graph's
tensors and what the loop derives from them once (the transposed view,
the degree vector, the density constants). The planner looks plans up by
a :class:`PlanKey` built from

  - the graph's **structure fingerprint** (``GraphMatrix.fingerprint``:
    two wrappers around the same adjacency share plans),
  - the **kernel** name (msbfs / mskhop / ppr),
  - the graph's **device** (``"cpu"``, ``"cuda:0"``): a plan closes
    over the graph's tensors, so the same structure on two devices
    needs two plans,
  - **backend**, **tile_dim** and the **bucket layout** (per-bucket
    (rows, width) pairs of the ``b2sr`` word schemes; the ``b2sr_cuda``
    and ``csr`` rows read no bucketed slabs, so theirs is None),
  - the **padded batch width** (frontier columns after word padding; the
    batcher also rounds widths up to powers of two),
  - the descriptor fields the loop bakes in (:func:`descriptor_key`).

Eviction is LRU with a fixed capacity. The reference's telemetry hooks
(cache counters, launch-latency histograms, cost accounting and trace
spans) wait for the port's telemetry slice (ROADMAP Queue 1 item 8), and
the ``mesh`` field stays None until the multi-GPU slice (item 9).
"""

from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Callable, Optional, Tuple

from repro_torch.core.descriptor import Descriptor
from repro_torch.core.graphblas import GraphMatrix


@dataclasses.dataclass(frozen=True)
class PlanKey:
    graph_fp: str
    kernel: str
    device: str                 # the graph's device, e.g. "cpu", "cuda:0"
    backend: str
    tile_dim: int
    bucket_layout: Optional[Tuple[Tuple[int, int], ...]]
    batch_width: int            # padded number of frontier columns (S_pad)
    # descriptor fields the loop bakes in (``descriptor_key``); None for
    # plans whose loop shape is fully named by ``kernel``
    desc: Optional[Tuple] = None
    # the mesh of a sharded graph; always None until the multi-GPU slice
    mesh: Optional[Tuple] = None


def descriptor_key(desc: Descriptor,
                   masked: Optional[bool] = None) -> Tuple:
    """Hashable summary of the :class:`Descriptor` fields a plan bakes in:
    mask presence, complement, input transpose, replace semantics, row
    chunking and direction. ``masked`` overrides mask presence for loops
    whose mask is built inside the loop."""
    m = (desc.mask is not None) if masked is None else masked
    return (m, desc.complement, desc.transpose_a, desc.replace,
            desc.row_chunk, desc.direction)


@dataclasses.dataclass
class Plan:
    """A cached batched query loop; ``n_calls`` counts its launches."""

    key: PlanKey
    fn: Callable
    n_calls: int = 0

    def __call__(self, *args, **kw):
        self.n_calls += 1
        return self.fn(*args, **kw)


def plan_key(g: GraphMatrix, kernel: str, batch_width: int,
             desc: Optional[Tuple] = None) -> PlanKey:
    """The cache key for ``kernel`` on ``g`` at ``batch_width``."""
    bucket_layout = None
    if g.backend == "b2sr" and g.use_buckets:
        b = g.buckets()
        bucket_layout = tuple((int(c.shape[0]), int(c.shape[1]))
                              for c in b.col_idx)
    return PlanKey(graph_fp=g.fingerprint(), kernel=kernel,
                   device=str(g.device), backend=g.backend, tile_dim=g.tile_dim,
                   bucket_layout=bucket_layout, batch_width=batch_width,
                   desc=desc)


class PlanCache:
    """LRU cache of :class:`Plan` objects with hit/miss/eviction counts."""

    def __init__(self, capacity: int = 32):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.capacity = capacity
        self._plans: "OrderedDict[PlanKey, Plan]" = OrderedDict()
        self._stats = {"hits": 0, "misses": 0, "evictions": 0}

    @property
    def hits(self) -> int:
        return self._stats["hits"]

    @property
    def misses(self) -> int:
        return self._stats["misses"]

    @property
    def evictions(self) -> int:
        return self._stats["evictions"]

    def stats(self) -> dict:
        """Counter snapshot plus occupancy, as one plain dict."""
        return {**self._stats, "size": len(self._plans),
                "capacity": self.capacity}

    def reset_stats(self) -> None:
        for k in self._stats:
            self._stats[k] = 0

    def get(self, key: PlanKey, builder: Callable[[], Callable]) -> Plan:
        """The plan for ``key``, building (and possibly evicting) on a miss."""
        plan = self._plans.get(key)
        if plan is not None:
            self._plans.move_to_end(key)
            self._stats["hits"] += 1
            return plan
        self._stats["misses"] += 1
        plan = Plan(key=key, fn=builder())
        self._plans[key] = plan
        while len(self._plans) > self.capacity:
            self._plans.popitem(last=False)
            self._stats["evictions"] += 1
        return plan

    def __len__(self) -> int:
        return len(self._plans)

    def __contains__(self, key: PlanKey) -> bool:
        return key in self._plans

    def keys(self):
        return list(self._plans.keys())

    def clear(self) -> None:
        self._plans.clear()
        self.reset_stats()


#: The cache that the GraphMatrix entry points and the batcher use; pass
#: an explicit PlanCache to ``engine.queries`` for isolated lifetimes.
DEFAULT_PLANNER = PlanCache()
