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
  - the descriptor fields the loop bakes in (:func:`descriptor_key`),
  - for a sharded graph, the **mesh fingerprint** and the combine mode
    (``partition.mesh_fingerprint``: axis names, shape, shard axes, each
    slot's position and device), so plans never leak across meshes, comm
    layouts, or between a sharded graph and its unsharded twin.

Eviction is LRU with a fixed capacity.

Telemetry, as the reference's (DESIGN.md §14): the cache counts hits,
misses and evictions into ``plan_cache_{hits,misses,evictions}_total
{kind,backend}`` and opens a ``plan_resolve`` span on the ambient trace;
each plan call lands one ``launch_latency_s`` observation, labeled by
the plan-key coordinates, and tags the enclosing span with
``first_call`` / ``op``. On a CUDA graph the window ends after
``torch.cuda.synchronize`` (``SYNC_LATENCY``), so the histogram holds
finished work; with observability off no sync is added. With cost accounting on, a plan's
first call is counted (``repro_torch.obs.cost``) into ``Plan.cost``.

Dispatch hooks fire where the reference's would: a plan's first call runs
in a fresh resolution scope (the reference traces it), a warm plan's calls
in a muted one (a compiled plan resolves nothing; see
``repro_torch.core.dispatch``). A plan turns warm once a call completes.
"""

from __future__ import annotations

import dataclasses
import time
from collections import OrderedDict
from typing import Callable, Optional, Tuple

import torch

from repro_torch.core import dispatch
from repro_torch.core.descriptor import Descriptor
from repro_torch.core.graphblas import GraphMatrix
from repro_torch.obs import cost as obs_cost
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace

#: Labels the planner stamps on its registry series.
_CACHE_LABELS = ("kind", "backend")
_LAUNCH_LABELS = ("op", "backend", "tile_dim", "bucketed", "sharded")

#: End a CUDA plan's ``launch_latency_s`` window after a device sync (the
#: histogram holds finished work). False ends it when the call returns,
#: which times the host's launches only and adds no sync.
SYNC_LATENCY = True


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
    # the mesh fingerprint plus the combine mode of a sharded graph (a
    # plan closes over the shards' blocks); None when unsharded
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
    """A cached batched query loop; ``n_calls`` counts its launches.

    ``cost`` is the plan's counted cost (FLOPs / HBM bytes / wire bytes
    per launch and each hand kernel's share), filled on the first call
    while :func:`repro_torch.obs.cost.set_cost_accounting` is on, else
    None. Every call lands one observation in the ``launch_latency_s``
    histogram, labeled by the plan-key coordinates.
    """

    key: PlanKey
    fn: Callable
    n_calls: int = 0
    cost: Optional[dict] = None
    warm: bool = False

    def _labels(self) -> dict:
        return {"op": self.key.kernel, "backend": self.key.backend,
                "tile_dim": self.key.tile_dim,
                "bucketed": self.key.bucket_layout is not None,
                "sharded": self.key.mesh is not None}

    def __call__(self, *args, **kw):
        first = not self.warm
        self.n_calls += 1
        with dispatch.fresh_scope() if first else dispatch.muted():
            out = self._run(first, args, kw)
        self.warm = True
        return out

    def _run(self, first: bool, args, kw):
        if not obs_metrics.enabled():
            return self.fn(*args, **kw)
        if first and self.cost is None and obs_cost.cost_accounting_enabled():
            self.cost = obs_cost.analyze_plan(self.fn, args, kw)
            obs_cost.record_plan_cost(self.cost, self.key.kernel,
                                      self.key.backend, self.key.tile_dim)
        # tag the enclosing launch span: a first call pays the work-item
        # cuts and the first kernel builds inside this launch
        obs_trace.annotate(first_call=first, op=self.key.kernel)
        t0 = time.perf_counter()
        out = self.fn(*args, **kw)
        if SYNC_LATENCY and self.key.device.startswith("cuda"):
            torch.cuda.synchronize(self.key.device)
        obs_metrics.get_registry().histogram(
            "launch_latency_s", "plan launch wall time",
            _LAUNCH_LABELS).observe(time.perf_counter() - t0,
                                    **self._labels())
        return out


def plan_key(g: GraphMatrix, kernel: str, batch_width: int,
             desc: Optional[Tuple] = None) -> PlanKey:
    """The cache key for ``kernel`` on ``g`` at ``batch_width``."""
    bucket_layout = None
    if g.backend == "b2sr" and g.use_buckets:
        b = g.buckets()
        bucket_layout = tuple((int(c.shape[0]), int(c.shape[1]))
                              for c in b.col_idx)
    mesh_fp = None
    if g.sharded:
        from repro_torch.core.partition import mesh_fingerprint
        mesh_fp = mesh_fingerprint(g.mesh, g.shard_axes) + (g.comm,)
    return PlanKey(graph_fp=g.fingerprint(), kernel=kernel,
                   device=str(g.device), backend=g.backend, tile_dim=g.tile_dim,
                   bucket_layout=bucket_layout, batch_width=batch_width,
                   desc=desc, mesh=mesh_fp)


class PlanCache:
    """LRU cache of :class:`Plan` objects with hit/miss/eviction counts.

    The counts live in one dict (:meth:`stats` / :meth:`reset_stats`) and
    are mirrored into the metrics registry (``registry``, or the default
    one at emit time) as ``plan_cache_{hits,misses,evictions}_total
    {kind,backend}``.
    """

    def __init__(self, capacity: int = 32,
                 registry: Optional["obs_metrics.MetricsRegistry"] = None):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.capacity = capacity
        self._plans: "OrderedDict[PlanKey, Plan]" = OrderedDict()
        self._registry = registry
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

    def _count(self, what: str, key: PlanKey) -> None:
        self._stats[what] += 1
        if obs_metrics.enabled():
            reg = self._registry or obs_metrics.get_registry()
            reg.counter(f"plan_cache_{what}_total",
                        f"plan cache {what}", _CACHE_LABELS).inc(
                kind=key.kernel, backend=key.backend)

    def get(self, key: PlanKey, builder: Callable[[], Callable]) -> Plan:
        """The plan for ``key``, building (and possibly evicting) on a miss."""
        plan = self._plans.get(key)
        with obs_trace.current_span("plan_resolve", cache_hit=plan is not None,
                                    op=key.kernel, backend=key.backend):
            if plan is not None:
                self._plans.move_to_end(key)
                self._count("hits", key)
                return plan
            self._count("misses", key)
            plan = Plan(key=key, fn=builder())
            self._plans[key] = plan
            while len(self._plans) > self.capacity:
                old_key, _ = self._plans.popitem(last=False)
                self._count("evictions", old_key)
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
