"""Fault-tolerant graph query serving on top of the batching engine.

``GraphQueryServer`` wraps :class:`~repro_torch.engine.batcher.QueryBatcher`'s
coalescing core with the behaviors that survive contact with real traffic
(DESIGN.md §13):

  **Deadline-aware admission.** Every submit carries a latency budget;
  ``poll()`` fires a flush when the *oldest* pending query's deadline
  comes within ``flush_margin_s`` — latency-bound traffic no longer waits
  for a batch to fill. Fill still flushes too (``max_batch``), so the
  pow2-padded plan reuse from the batcher is unchanged. Admission is a
  bounded queue: overflow is **rejected** (:class:`QueryRejected`,
  synchronously, so the caller can retry elsewhere), never silently
  dropped — a submitted query always resolves.

  **Graceful degradation.** Every Table II/III row is registered on three
  bit-exact backends, so a backend that is unavailable (an injected
  fault, the card out of memory: ``FALLBACK_ERRORS``) is not an error —
  it is a *downgrade*. Each group runs behind a per-(kind, backend) circuit
  breaker: a failure is retried once with exponential backoff, then the
  group falls through the ``b2sr_cuda → b2sr → csr`` chain. After
  ``fail_threshold`` consecutive failures the breaker opens and traffic
  skips the backend outright; after ``cooldown_s`` it half-opens and one
  probe group tests recovery (success closes it, failure re-opens). The
  downgrade is recorded on the result handle (``handle.degraded``,
  ``handle.backend_used``).

  **Restart-safe warmup.** Every successful launch records a *plan
  recipe* — (graph fingerprint, kind, params, padded width, backend,
  layout flags), the serialisable identity of a
  :class:`~repro_torch.engine.planner.PlanKey`. ``save_warmup(path)``
  persists the set; ``warmup(path)`` on a restarted server replays each
  recipe against its registered graphs, rebuilding the hot plans (work
  items, kernel builds) before the first query pays for them (keys are
  persisted, not plans — see DESIGN.md §13).

  **Deterministic fault injection.** Pass a
  :class:`~repro_torch.engine.faults.FaultInjector` and the server consults it
  per launch attempt (and, when installed, the dispatch layer consults it
  per kernel resolution), so every behavior above is testable without
  real GPU faults.

Only the faults in ``FALLBACK_ERRORS`` send a group down the chain: an
injected fault and the card running out of memory. Any other error is no
backend's unavailability but a fault of the program: a kernel that did
not build or launch (``repro_torch.kernels.common.KernelError``), or an
error of the port's own code. It is neither retried nor answered on a
fallback backend: it fails its group's handles, and the flush (or the
``submit`` that triggered it) raises it once every group of the flush
has run. ``warmup`` raises it too. So a kernel that is broken on the card
never gives way to a plain version there.

A sharded graph's ``csr`` view is its unsharded twin (the ``csr``
backend has no sharded rows); recipes carry the graph's ``sharded`` flag,
and ``warmup`` replays a recipe only on a graph whose flag matches.

The server is a synchronous event loop citizen: ``submit`` / ``poll`` /
``flush`` from one thread, with an injectable clock for deterministic
tests. ``handle.result()`` force-flushes, so a bare client can never hang
on an un-flushed queue.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.core.dispatch import InjectedFault
from repro_torch.core.graphblas import GraphMatrix
from repro_torch.engine import warmup as warmup_mod
from repro_torch.engine.batcher import (QueryGroupError, QueryHandle,
                                        _Pending, launch_group,
                                        validate_query)
from repro_torch.engine.faults import FaultInjector
from repro_torch.engine.planner import PlanCache
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace

#: Backend downgrade order: most-optimized first, the always-available
#: float-CSR baseline last. A graph's chain starts at its own backend.
FALLBACK_CHAIN = ("b2sr_cuda", "b2sr", "csr")

#: The errors a launch attempt may fall back from: the fault injector's
#: and the card's out-of-memory error. Any other error fails its group
#: and is raised (see the module docstring).
FALLBACK_ERRORS = (InjectedFault, torch.OutOfMemoryError)


class QueryRejected(RuntimeError):
    """Admission-control rejection: the bounded queue is full.

    Raised synchronously from ``submit`` (the caller knows immediately and
    can back off / retry elsewhere) — overflow is never enqueued-and-
    dropped, so an accepted query always resolves.
    """

    def __init__(self, depth: int, max_queue: int):
        self.depth = depth
        self.max_queue = max_queue
        super().__init__(
            f"queue full ({depth}/{max_queue} pending); retry later")


# -- circuit breaker ---------------------------------------------------------

CLOSED, OPEN, HALF_OPEN = "closed", "open", "half_open"


class CircuitBreaker:
    """Per-(kind, backend) failure gate with open → half-open recovery.

    ``fail_threshold`` *consecutive* failures open the breaker: traffic
    skips the backend without paying its failure latency. After
    ``cooldown_s`` the next ``allow()`` half-opens it — one probe group
    runs; success closes the breaker, failure re-opens it (and restarts
    the cooldown). Clock is injectable so tests pin transitions exactly.

    Every state change is recorded: ``transitions`` is the timestamped
    ``(ts, from, to)`` log and ``state_counts`` counts entries into each
    state (``closed`` starts at 1 — the breaker is born closed).
    ``on_transition(old, new, ts)``, when given, lets an owner mirror
    transitions into the metrics registry (the server does; see
    DESIGN.md §14).
    """

    def __init__(self, fail_threshold: int = 3, cooldown_s: float = 0.5,
                 clock: Callable[[], float] = time.monotonic,
                 on_transition: Optional[Callable[[str, str, float],
                                                  None]] = None):
        if fail_threshold < 1:
            raise ValueError("fail_threshold must be >= 1")
        self.fail_threshold = fail_threshold
        self.cooldown_s = cooldown_s
        self._clock = clock
        self.on_transition = on_transition
        self.state = CLOSED
        self.failures = 0           # consecutive, while closed
        self.opened_at: Optional[float] = None
        self.n_opens = 0
        self.transitions: List[Tuple[float, str, str]] = []
        self.state_counts: Dict[str, int] = {CLOSED: 1, OPEN: 0,
                                             HALF_OPEN: 0}

    def _set_state(self, new: str) -> None:
        if new == self.state:
            return
        ts = self._clock()
        old = self.state
        self.state = new
        self.transitions.append((ts, old, new))
        self.state_counts[new] += 1
        if self.on_transition is not None:
            self.on_transition(old, new, ts)

    def allow(self) -> bool:
        if self.state == CLOSED:
            return True
        if (self.state == OPEN
                and self._clock() - self.opened_at >= self.cooldown_s):
            self._set_state(HALF_OPEN)
            return True
        return self.state == HALF_OPEN

    def record_success(self) -> None:
        self._set_state(CLOSED)
        self.failures = 0
        self.opened_at = None

    def record_failure(self) -> None:
        if self.state == HALF_OPEN:
            self._open()                     # failed probe: back to open
        else:
            self.failures += 1
            if self.failures >= self.fail_threshold:
                self._open()

    def _open(self) -> None:
        self._set_state(OPEN)
        self.opened_at = self._clock()
        self.failures = 0
        self.n_opens += 1

    def stats(self) -> dict:
        """One-dict snapshot: state, counters, and the transition log."""
        return {"state": self.state, "failures": self.failures,
                "n_opens": self.n_opens,
                "state_counts": dict(self.state_counts),
                "transitions": list(self.transitions)}


class ServerStats(dict):
    """The server's counter dict that is *also* callable.

    ``server.stats["completed"]`` keeps the historical counter access;
    ``server.stats()`` returns the aggregated one-dict snapshot — counters,
    queue depth, per-(kind, backend) breaker states with transition logs,
    plan-cache stats, and registered graph/recipe counts.
    """

    def __init__(self, server: "GraphQueryServer", **counters):
        super().__init__(**counters)
        self._server = server

    def __call__(self) -> dict:
        return self._server._stats_snapshot()


# -- server ------------------------------------------------------------------

@dataclasses.dataclass
class ServerConfig:
    """Knobs for admission, flushing, retry/fallback, and breakers."""

    max_queue: int = 1024            # bounded admission queue (reject over)
    max_batch: int = 256             # fill-flush threshold / group chunking
    default_budget_s: float = 0.100  # per-query latency budget if unset
    flush_margin_s: float = 0.005    # flush when a deadline is this close
    max_retries: int = 1             # same-backend retries before falling
    backoff_base_s: float = 0.0      # exp backoff: base * 2**attempt
    fail_threshold: int = 3          # consecutive failures to open a breaker
    cooldown_s: float = 0.5          # open -> half-open probe delay


@dataclasses.dataclass
class LaunchRecord:
    """Audit-log row: what one group launch actually executed.

    ``sources`` is the exact padded source tuple handed to the engine, so
    a degraded answer can be re-derived (and checked bit-exact) on the
    healthy backend by replaying the identical launch.
    """

    kind: str
    params: Tuple[Tuple[str, Any], ...]
    sources: Tuple[int, ...]
    graph_fp: str
    backend: str
    degraded: bool
    attempts: int


@dataclasses.dataclass
class _ServerPending(_Pending):
    deadline: float = 0.0


class GraphQueryServer:
    """Deadline-aware, fault-tolerant front end for batched graph queries."""

    def __init__(self, planner: Optional[PlanCache] = None,
                 config: Optional[ServerConfig] = None,
                 fault_injector: Optional[FaultInjector] = None,
                 clock: Callable[[], float] = time.monotonic,
                 sleep: Callable[[float], None] = time.sleep,
                 registry: Optional[obs_metrics.MetricsRegistry] = None,
                 max_traces: int = 1024):
        self.planner = planner if planner is not None else PlanCache()
        self.config = config if config is not None else ServerConfig()
        self.injector = fault_injector
        self._clock = clock
        self._sleep = sleep
        self._registry = registry            # None -> default at emit time
        self._pending: List[_ServerPending] = []
        self._graphs: Dict[str, GraphMatrix] = {}
        self._backend_views: Dict[Tuple[int, str], GraphMatrix] = {}
        self._breakers: Dict[Tuple[str, str], CircuitBreaker] = {}
        self._recipes: Dict[tuple, dict] = {}
        self.launch_log: List[LaunchRecord] = []
        #: completed-query traces, newest last (bounded; see dump_traces)
        self.trace_log: deque = deque(maxlen=max_traces)
        self.stats = ServerStats(
            self,
            submitted=0, completed=0, rejected=0, deduped=0,
            failed_queries=0, flushes=0, deadline_flushes=0,
            fill_flushes=0, launches=0, degraded_launches=0,
            retries=0, breaker_skips=0, warmup_replayed=0,
            warmup_skipped=0, warmup_failed=0,
        )

    # -- observability -------------------------------------------------------
    def _reg(self) -> obs_metrics.MetricsRegistry:
        return self._registry or obs_metrics.get_registry()

    def _count(self, name: str, help: str, n: float = 1, **labels) -> None:
        if obs_metrics.enabled():
            self._reg().counter("server_" + name, help,
                                tuple(sorted(labels))).inc(n, **labels)

    def _queue_gauge(self) -> None:
        if obs_metrics.enabled():
            self._reg().gauge("server_queue_depth",
                              "pending (admitted, unflushed) queries").set(
                len(self._pending))

    def _on_breaker_transition(self, kind: str, backend: str, old: str,
                               new: str, ts: float) -> None:
        if not obs_metrics.enabled():
            return
        reg = self._reg()
        reg.counter("server_breaker_transitions_total",
                    "circuit breaker state changes",
                    ("kind", "backend", "to")).inc(kind=kind,
                                                   backend=backend, to=new)
        reg.gauge("server_breaker_state", "0=closed 1=half_open 2=open",
                  ("kind", "backend")).set(
            {CLOSED: 0, HALF_OPEN: 1, OPEN: 2}[new], kind=kind,
            backend=backend)
        reg.event("breaker_transition", kind=kind, backend=backend,
                  from_state=old, to_state=new, at=ts)

    def _stats_snapshot(self) -> dict:
        """Everything operational about this server in one plain dict."""
        return {
            "counters": {k: v for k, v in self.stats.items()},
            "queue_depth": len(self._pending),
            "breakers": {f"{kind}/{backend}": br.stats()
                         for (kind, backend), br in
                         sorted(self._breakers.items())},
            "plan_cache": self.planner.stats(),
            "graphs": len(self._graphs),
            "recipes": len(self._recipes),
            "traces_held": len(self.trace_log),
        }

    # -- graph registry ------------------------------------------------------
    def register(self, graph: GraphMatrix) -> str:
        """Register a graph for serving and warmup replay; returns its
        structure fingerprint (idempotent — same fingerprint re-registers)."""
        fp = graph.fingerprint()
        self._graphs[fp] = graph
        return fp

    # -- admission -----------------------------------------------------------
    def submit(self, graph: GraphMatrix, kind: str, source: int,
               budget_s: Optional[float] = None, **params) -> QueryHandle:
        """Admit one query; returns a handle resolving within its budget.

        Raises :class:`QueryRejected` when the bounded queue is full and
        ``ValueError`` for an unknown kind or an out-of-range source —
        both synchronously, before any state changes. A fill flush it
        triggers raises a program fault (module docstring) after every
        group has run; the query has then resolved with that error.
        """
        t0 = time.monotonic()
        src = validate_query(graph, kind, source)
        if len(self._pending) >= self.config.max_queue:
            self.stats["rejected"] += 1
            self._count("queries_rejected_total",
                        "admission-control rejections", kind=kind)
            raise QueryRejected(len(self._pending), self.config.max_queue)
        self.register(graph)
        budget = (self.config.default_budget_s if budget_s is None
                  else float(budget_s))
        handle = QueryHandle(self)
        deadline = self._clock() + budget
        handle.deadline = deadline
        if handle.trace is not None:
            handle.trace.attrs.update(kind=kind, source=src,
                                      budget_s=budget)
            handle.trace.add_span("submit", t0, time.monotonic())
        self._pending.append(_ServerPending(
            graph=graph, kind=kind, source=src,
            params=tuple(sorted(params.items())), handle=handle,
            submitted_at=time.monotonic(), deadline=deadline))
        self.stats["submitted"] += 1
        self._count("queries_submitted_total", "admitted queries",
                    kind=kind)
        self._queue_gauge()
        if len(self._pending) >= self.config.max_batch:
            self._flush("fill")
        return handle

    def bfs(self, graph, source, budget_s=None, max_iters=None):
        return self.submit(graph, "bfs", source, budget_s=budget_s,
                           max_iters=max_iters)

    def khop(self, graph, source, k, budget_s=None):
        return self.submit(graph, "khop", source, budget_s=budget_s, k=k)

    def sssp(self, graph, source, budget_s=None, edge_weight=1.0):
        return self.submit(graph, "sssp", source, budget_s=budget_s,
                           edge_weight=edge_weight)

    def ppr(self, graph, seed, budget_s=None, alpha=0.85, max_iters=10,
            eps=1e-9):
        return self.submit(graph, "ppr", seed, budget_s=budget_s,
                           alpha=alpha, max_iters=max_iters, eps=eps)

    def gnn_infer(self, graph, node, model, budget_s=None):
        """Batched GNN inference for one node (BitGNN forward; DESIGN.md
        §15): class scores from the model registered under ``model`` with
        ``engine.queries.register_gnn_model``. Coalesces with every other
        pending query for the same (graph, model) into one full-graph
        forward, behind the same deadline/fallback/warmup machinery."""
        return self.submit(graph, "gnn_infer", node, budget_s=budget_s,
                           model=model)

    # -- flushing ------------------------------------------------------------
    def pending(self) -> int:
        return len(self._pending)

    def next_deadline(self) -> Optional[float]:
        if not self._pending:
            return None
        return min(q.deadline for q in self._pending)

    def due(self, now: Optional[float] = None) -> bool:
        """Whether the oldest pending deadline is within the flush margin."""
        dl = self.next_deadline()
        if dl is None:
            return False
        now = self._clock() if now is None else now
        return dl - now <= self.config.flush_margin_s

    def poll(self) -> int:
        """Deadline pump: flush everything once any deadline nears.

        Call from the serving loop (or a timer). Returns the number of
        queries flushed (0 when nothing is due).
        """
        if not self.due():
            return 0
        n = len(self._pending)
        self._flush("deadline")
        return n

    def flush(self, raise_errors: bool = False) -> None:
        """Force-run everything pending (``handle.result()`` calls this).

        Unlike ``QueryBatcher.flush`` this is quiet by default: failures
        are terminal per-handle verdicts (the fallback chain already ran),
        and the serving loop must not die with them. A program fault
        (module docstring) is the exception: it fails its group's handles
        and is raised once every group has run.
        """
        del raise_errors                     # errors live on the handles
        if self._pending:
            self._flush("forced")

    def _flush(self, reason: str) -> None:
        groups: Dict[Tuple, List[_ServerPending]] = {}
        for q in self._pending:
            groups.setdefault((id(q.graph), q.kind, q.params), []).append(q)
        self._pending = []
        self.stats["flushes"] += 1
        self._count("flushes_total", "queue flushes by trigger",
                    reason=reason)
        self._queue_gauge()
        if reason == "deadline":
            self.stats["deadline_flushes"] += 1
        elif reason == "fill":
            self.stats["fill_flushes"] += 1
        fault: Optional[BaseException] = None
        for (_, kind, params), qs in groups.items():
            for start in range(0, len(qs), self.config.max_batch):
                try:
                    self._run_group(kind, params, qs[start:start
                                                     + self.config.max_batch])
                except Exception as e:       # noqa: BLE001 — raised below
                    fault = fault or e
        if fault is not None:                # every handle has resolved
            raise fault

    # -- fallback execution --------------------------------------------------
    def _chain_for(self, g: GraphMatrix) -> Tuple[str, ...]:
        try:
            idx = FALLBACK_CHAIN.index(g.backend)
        except ValueError:                   # unknown backend: no fallback
            return (g.backend,)
        return FALLBACK_CHAIN[idx:]

    def _backend_view(self, g: GraphMatrix, backend: str) -> GraphMatrix:
        """``g`` on ``backend`` (memoized): ``csr`` unshards, having no
        sharded rows."""
        if backend == g.backend:
            return g
        key = (id(g), backend)
        view = self._backend_views.get(key)
        if view is None:
            base = g.unshard() if (backend == "csr" and g.sharded) else g
            view = base.with_backend(backend)
            self._backend_views[key] = view
        return view

    def breaker(self, kind: str, backend: str) -> CircuitBreaker:
        key = (kind, backend)
        br = self._breakers.get(key)
        if br is None:
            br = CircuitBreaker(
                self.config.fail_threshold, self.config.cooldown_s,
                self._clock,
                on_transition=lambda old, new, ts, k=kind, b=backend:
                    self._on_breaker_transition(k, b, old, new, ts))
            self._breakers[key] = br
        return br

    def _run_group(self, kind: str, params: Tuple[Tuple[str, Any], ...],
                   qs: List[_ServerPending]) -> None:
        g = qs[0].graph
        chain = self._chain_for(g)
        last_err: Optional[BaseException] = None
        attempts = 0
        for backend in chain:
            br = self.breaker(kind, backend)
            if not br.allow():
                self.stats["breaker_skips"] += 1
                continue
            for attempt in range(self.config.max_retries + 1):
                attempts += 1
                try:
                    gv = self._backend_view(g, backend)
                    if self.injector is not None:
                        self.injector.check(kind, backend)
                    self.stats["launches"] += 1
                    n_dedup, padded = launch_group(gv, kind, dict(params),
                                                   qs, self.planner)
                except FALLBACK_ERRORS as e:
                    last_err = e
                    br.record_failure()
                    if (attempt < self.config.max_retries
                            and br.state == CLOSED):
                        self.stats["retries"] += 1
                        self._sleep(self.config.backoff_base_s
                                    * (2 ** attempt))
                        continue
                    break                    # breaker opened or retries spent
                except Exception as e:       # noqa: BLE001 — a program fault
                    self._fail_group(kind, params, qs, attempts, e)
                    raise
                br.record_success()
                self._finish_group(kind, params, qs, gv, g, padded,
                                   n_dedup, attempts)
                return
        self._fail_group(kind, params, qs, attempts,
                         last_err if last_err is not None
                         else RuntimeError(f"all backends unavailable "
                                           f"(breakers open for {chain})"))

    def _fail_group(self, kind: str, params: Tuple[Tuple[str, Any], ...],
                    qs: List[_ServerPending], attempts: int,
                    cause: BaseException) -> None:
        err = QueryGroupError(kind, params, len(qs), cause)
        self.stats["failed_queries"] += len(qs)
        self._count("queries_failed_total",
                    "queries whose whole fallback chain failed",
                    len(qs), kind=kind)
        if obs_metrics.enabled():
            self._reg().event("group_failed", kind=kind, n_queries=len(qs),
                              attempts=attempts, error=repr(err.__cause__))
        for q in qs:
            q.handle._fail(err)
            if q.handle.trace is not None:
                q.handle.trace.attrs.update(failed=True,
                                            error=repr(err.__cause__))
                self.trace_log.append(q.handle.trace)

    def _finish_group(self, kind, params, qs, gv: GraphMatrix,
                      g: GraphMatrix, padded: Tuple[int, ...],
                      n_dedup: int, attempts: int) -> None:
        degraded = gv.backend != g.backend
        now = self._clock()
        for q in qs:
            q.handle.backend_used = gv.backend
            q.handle.degraded = degraded
            q.handle.completed_at = now
            if q.handle.trace is not None:
                q.handle.trace.attrs.update(backend_used=gv.backend,
                                            degraded=degraded,
                                            attempts=attempts)
                self.trace_log.append(q.handle.trace)
        self.stats["completed"] += len(qs)
        self.stats["deduped"] += n_dedup
        self._count("queries_completed_total", "fulfilled queries",
                    len(qs), kind=kind, backend=gv.backend,
                    degraded=degraded)
        if degraded:
            self.stats["degraded_launches"] += 1
            self._count("degraded_launches_total",
                        "launches answered on a fallback backend",
                        kind=kind, backend=gv.backend)
        fp = g.fingerprint()
        self.launch_log.append(LaunchRecord(
            kind=kind, params=params, sources=padded, graph_fp=fp,
            backend=gv.backend, degraded=degraded, attempts=attempts))
        recipe = {
            "graph_fp": fp, "kind": kind, "params": dict(params),
            "width": len(padded), "backend": gv.backend,
            "use_buckets": bool(gv.use_buckets),
            "sharded": bool(g.sharded),
        }
        self._recipes[warmup_mod.recipe_key(recipe)] = recipe

    # -- trace export --------------------------------------------------------
    def dump_traces(self, path: str, append: bool = False,
                    clear: bool = True) -> int:
        """Write completed-query traces as JSONL; returns how many.

        ``clear`` (default) drains the bounded buffer so a periodic dump
        loop never re-writes old traces.
        """
        n = obs_trace.write_jsonl(path, list(self.trace_log), append=append)
        if clear:
            self.trace_log.clear()
        return n

    # -- restart-safe warmup -------------------------------------------------
    def save_warmup(self, path: str) -> int:
        """Persist the served plan-recipe set; returns how many were saved."""
        return warmup_mod.save(path, self._recipes.values())

    def warmup(self, path: str) -> int:
        """Replay a warmup file: rebuild hot plans for registered graphs.

        Each recipe whose graph fingerprint is registered (and whose
        sharded flag matches the graph's) is replayed as one dummy launch
        of the recorded kind/width/backend — populating ``self.planner``
        with exactly the plan the live query would need. Returns the
        number of recipes replayed; mismatched recipes are counted in
        ``stats['warmup_skipped']`` and recipes whose launch hit one of
        ``FALLBACK_ERRORS`` in ``['warmup_failed']``, and neither aborts
        startup; any other error (a kernel that does not build or launch)
        is raised.
        """
        n = 0
        for r in warmup_mod.load(path):
            g = self._graphs.get(r["graph_fp"])
            if (g is None or bool(g.sharded) != r["sharded"]
                    or r["width"] > g.n_rows):
                self.stats["warmup_skipped"] += 1
                continue
            base = g if g.use_buckets == r["use_buckets"] else \
                g.with_buckets(r["use_buckets"])
            gv = self._backend_view(base, r["backend"])
            # distinct sources so in-flight dedup keeps the padded width
            qs = [_Pending(graph=gv, kind=r["kind"], source=i,
                           params=tuple(sorted(r["params"].items())),
                           handle=QueryHandle(None))
                  for i in range(r["width"])]
            try:
                launch_group(gv, r["kind"], dict(r["params"]), qs,
                             self.planner)
                n += 1
            except FALLBACK_ERRORS:          # a program fault aborts boot
                self.stats["warmup_failed"] += 1
        self.stats["warmup_replayed"] += n
        return n
