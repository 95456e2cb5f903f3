"""Request coalescing: single queries -> padded power-of-two batches.

Callers submit individual queries ("BFS from node 17", "PPR seeded at
node 3") and get a handle back; ``flush()`` groups the pending queries by
(graph, kind, parameters), pads each group's source list to the next
power of two, runs **one** engine launch per group, and scatters result
columns back onto the handles.

Padding to powers of two: the planner keys plans by padded batch width,
so rounded widths collapse arbitrary traffic (3 queries, then 9, then
6 ...) onto a few cached plans. Padding columns repeat the group's first
source and are dropped at scatter-back; columns are independent, so a
duplicate costs only lanes that word packing had reserved anyway.

``gnn_infer`` queries group by model name (a query parameter), so each
model's queries share one forward.

Telemetry (DESIGN.md §14): each handle carries a trace (``submit`` and
its own ``queue_wait`` span, then the group's shared ``launch`` span,
with the planner's ``plan_resolve`` nested in it, and ``scatter_back``),
and every launch counts into ``engine_launches_total{kind,backend}`` and
``engine_deduped_total{kind}``. ``repro_torch.engine.server`` builds on
the same launch core and stamps its serving verdicts on the handles.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.graphblas import GraphMatrix
from repro_torch.engine import queries
from repro_torch.engine.planner import PlanCache
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace


def _next_pow2(n: int) -> int:
    return 1 << max(n - 1, 0).bit_length()


#: Query kinds of the coalescing layer.
KINDS = ("bfs", "khop", "sssp", "ppr", "gnn_infer")


def validate_query(graph: GraphMatrix, kind: str, source) -> int:
    """Check one query at submit time; returns the source as an int.

    Rejections happen here, with the graph's node count in the message,
    not as an out-of-range gather inside a launch.
    """
    if kind not in KINDS:
        raise ValueError(f"unknown query kind {kind!r}; expected one "
                         f"of {KINDS}")
    s = int(source)
    if not 0 <= s < graph.n_rows:
        raise ValueError(
            f"source {source} out of range for a graph with "
            f"{graph.n_rows} nodes (valid ids are 0..{graph.n_rows - 1})")
    return s


class QueryGroupError(RuntimeError):
    """One coalesced group's failure, with the group identity attached.

    Raised out of ``QueryHandle.result()`` and collected by ``flush``:
    callers see which group died (kind, parameters, size); the original
    exception rides on ``__cause__``.
    """

    def __init__(self, kind: str, params: Tuple[Tuple[str, Any], ...],
                 n_queries: int, cause: BaseException):
        self.kind = kind
        self.params = params
        self.n_queries = n_queries
        p = ", ".join(f"{k}={v!r}" for k, v in params)
        super().__init__(
            f"batched {kind!r} group ({p or 'no params'}; "
            f"{n_queries} queries) failed: {cause!r}")
        self.__cause__ = cause


class BatchFlushError(RuntimeError):
    """Raised by ``flush(raise_errors=True)`` when groups failed; ``errors``
    lists every failed group's :class:`QueryGroupError` in submission
    order."""

    def __init__(self, errors: List["QueryGroupError"]):
        self.errors = list(errors)
        lines = "\n  ".join(str(e) for e in self.errors)
        super().__init__(
            f"{len(self.errors)} query group(s) failed:\n  {lines}")
        self.__cause__ = self.errors[0]


class QueryHandle:
    """Future-style result slot; ``result()`` flushes the owning batcher.

    Serving metadata rides on the handle once it resolves:
    ``backend_used`` names the backend that produced the answer,
    ``degraded`` is True when the server answered on a fallback backend
    instead of the graph's own, ``completed_at`` is the server clock's
    time of the answer and ``deadline`` the query's deadline on it.
    ``trace`` holds the query's spans (None while observability is off).

    The first outcome wins (``_fulfill`` / ``_fail`` ignore later calls),
    so after a failure every ``result()`` raises the same error object.
    """

    def __init__(self, batcher):
        self._batcher = batcher
        self._result: Any = None
        self._error: Optional[BaseException] = None
        self._done = False
        self.backend_used: Optional[str] = None
        self.degraded: bool = False
        self.completed_at: Optional[float] = None
        self.deadline: Optional[float] = None
        self.trace = obs_trace.new_trace()

    def done(self) -> bool:
        return self._done

    def result(self) -> Any:
        if not self._done and self._batcher is not None:
            # quiet flush: a sibling group's failure stays on its handles
            self._batcher.flush(raise_errors=False)
        if self._error is not None:
            raise self._error
        return self._result

    def _fulfill(self, value: Any) -> None:
        if not self._done:
            self._result, self._done = value, True

    def _fail(self, err: BaseException) -> None:
        if not self._done:
            self._error, self._done = err, True


@dataclasses.dataclass
class _Pending:
    graph: GraphMatrix
    kind: str
    source: int
    params: Tuple[Tuple[str, Any], ...]
    handle: QueryHandle
    # monotonic admission time: the start of the queue_wait span (real
    # time, whatever clock a server's deadlines run on)
    submitted_at: float = 0.0


class QueryBatcher:
    """Coalesces single-source queries into batched engine launches.

    ``kind`` is ``"bfs"`` (-> levels ``int32[n]``), ``"khop"`` (-> reached
    ``bool[n]``), ``"sssp"`` (-> distances ``f32[n]``), ``"ppr"`` (->
    ranks ``f32[n]``) or ``"gnn_infer"`` (-> class scores
    ``f32[n_classes]``): each handle resolves to what the single-query
    call returns for that query.
    """

    def __init__(self, planner: Optional[PlanCache] = None,
                 max_batch: int = 256):
        self.planner = planner
        self.max_batch = max_batch
        self._pending: List[_Pending] = []
        self.n_queries = 0
        self.n_launches = 0
        self.n_deduped = 0

    # -- submission ---------------------------------------------------------
    def submit(self, graph: GraphMatrix, kind: str, source: int,
               **params) -> QueryHandle:
        t0 = time.monotonic()
        src = validate_query(graph, kind, source)
        handle = QueryHandle(self)
        if handle.trace is not None:
            handle.trace.attrs.update(kind=kind, source=src)
            handle.trace.add_span("submit", t0, time.monotonic())
        self._pending.append(_Pending(graph=graph, kind=kind, source=src,
                                      params=tuple(sorted(params.items())),
                                      handle=handle,
                                      submitted_at=time.monotonic()))
        self.n_queries += 1
        return handle

    def bfs(self, graph: GraphMatrix, source: int,
            max_iters: Optional[int] = None) -> QueryHandle:
        return self.submit(graph, "bfs", source, max_iters=max_iters)

    def khop(self, graph: GraphMatrix, source: int, k: int) -> QueryHandle:
        return self.submit(graph, "khop", source, k=k)

    def sssp(self, graph: GraphMatrix, source: int,
             edge_weight: float = 1.0) -> QueryHandle:
        return self.submit(graph, "sssp", source, edge_weight=edge_weight)

    def ppr(self, graph: GraphMatrix, seed: int, alpha: float = 0.85,
            max_iters: int = 10, eps: float = 1e-9) -> QueryHandle:
        return self.submit(graph, "ppr", seed, alpha=alpha,
                           max_iters=max_iters, eps=eps)

    def gnn_infer(self, graph: GraphMatrix, node: int,
                  model: str) -> QueryHandle:
        """Class scores of ``node`` from a registered GNN model
        (``engine.queries.register_gnn_model``): ``float32[n_classes]``."""
        return self.submit(graph, "gnn_infer", node, model=model)

    # -- execution ----------------------------------------------------------
    def pending(self) -> int:
        return len(self._pending)

    def flush(self, raise_errors: bool = True) -> None:
        """Run every pending group as one padded batched launch each.

        A failing group fails only its own handles, each with a
        :class:`QueryGroupError`; the other groups still run. With
        ``raise_errors`` a :class:`BatchFlushError` listing every failed
        group follows the sweep; ``result()`` flushes quietly.
        """
        groups: Dict[Tuple, List[_Pending]] = {}
        for q in self._pending:
            groups.setdefault((id(q.graph), q.kind, q.params), []).append(q)
        self._pending = []
        errors: List[QueryGroupError] = []
        for (_, kind, params), qs in groups.items():
            for start in range(0, len(qs), self.max_batch):
                chunk = qs[start:start + self.max_batch]
                try:
                    self._run_group(kind, dict(params), chunk)
                except Exception as e:   # noqa: BLE001 — stored per handle
                    err = QueryGroupError(kind, params, len(chunk), e)
                    for q in chunk:
                        q.handle._fail(err)
                    errors.append(err)
        if raise_errors and errors:
            raise BatchFlushError(errors)

    def _run_group(self, kind: str, params: dict,
                   qs: List[_Pending]) -> None:
        self.n_launches += 1
        n_dedup, _ = launch_group(qs[0].graph, kind, params, qs,
                                  self.planner)
        self.n_deduped += n_dedup


def launch_group(g: GraphMatrix, kind: str, params: dict,
                 qs: List[_Pending], planner: Optional[PlanCache]
                 ) -> Tuple[int, Tuple[int, ...]]:
    """Run one coalesced group as a single padded batched launch.

    The launch core under both :class:`QueryBatcher` and the server
    (which passes a fallback backend's view of the graph). Identical
    in-flight queries are deduplicated: duplicate sources share one batch
    column and every duplicate handle is fulfilled from it.
    Returns ``(n_deduped, padded_sources)``: how many queries shared a
    column, and the padded source tuple that was launched.

    The group gets one shared set of spans, ``launch`` (the planner's
    ``plan_resolve`` nests in it through the ambient trace) and
    ``scatter_back``, adopted into every member handle's trace beside
    that handle's own ``queue_wait``.
    """
    group_trace = obs_trace.new_trace("group", kind=kind,
                                      backend=g.backend)
    if group_trace is not None:
        t_start = time.monotonic()
        for q in qs:
            if q.handle.trace is not None and q.submitted_at:
                q.handle.trace.add_span("queue_wait", q.submitted_at,
                                        t_start)
    with obs_trace.use(group_trace):
        with obs_trace.current_span("launch", kind=kind,
                                    backend=g.backend, n_queries=len(qs)):
            sources = np.asarray([q.source for q in qs], np.int64)
            uniq, inv = np.unique(sources, return_inverse=True)
            s_pad = _next_pow2(uniq.size)
            # pad with the first source; the padding columns are dropped
            padded = np.concatenate(
                [uniq, np.full(s_pad - uniq.size, uniq[0], np.int64)])
            if kind == "bfs":
                out = queries.msbfs(g, padded, planner=planner,
                                    **params).levels
            elif kind == "khop":
                out = queries.mskhop(g, padded, planner=planner, **params)
            elif kind == "sssp":
                out = queries.ms_sssp(g, padded, planner=planner,
                                      **params).distances
            elif kind == "ppr":
                out = queries.batched_ppr(g, padded, planner=planner,
                                          **params).ranks
            elif kind == "gnn_infer":
                out = queries.gnn_infer(g, padded, planner=planner,
                                        **params).logits
            else:
                raise NotImplementedError(f"query kind {kind!r} has no "
                                          f"engine launch in the port")
        with obs_trace.current_span("scatter_back", n_queries=len(qs)):
            for q, col in zip(qs, inv.reshape(-1)):
                q.handle._fulfill(out[:, int(col)])
    if group_trace is not None:
        for q in qs:
            if q.handle.trace is not None:
                q.handle.trace.adopt(group_trace.spans)
    n_dedup = len(qs) - uniq.size
    if obs_metrics.enabled():
        reg = obs_metrics.get_registry()
        reg.counter("engine_launches_total", "coalesced group launches",
                    ("kind", "backend")).inc(kind=kind, backend=g.backend)
        reg.counter("engine_deduped_total",
                    "in-flight duplicate queries sharing a batch column",
                    ("kind",)).inc(n_dedup, kind=kind)
    return n_dedup, tuple(int(s) for s in padded)
