"""Graph-query serving driver: closed-loop traffic against GraphQueryServer.

  PYTHONPATH=src python -m repro_torch.launch.serve_queries \
      --scale 21 --backend b2sr_cuda --queries 96 --budget-ms 100

  # 10% injected kernel faults + warmup persistence across restarts:
  PYTHONPATH=src python -m repro_torch.launch.serve_queries \
      --backend b2sr_cuda --fault-rate 0.1 \
      --save-warmup plans.json --warmup plans.json

  # on the host, at a small size:
  PYTHONPATH=src python -m repro_torch.launch.serve_queries \
      --device cpu --n 128 --tile-dim 8

Drives a mixed bfs/khop/sssp/ppr stream through the fault-tolerant
serving layer (DESIGN.md §13) on an R-MAT graph and prints per-query
latency percentiles, flush/fallback/breaker counters, and — when
``--warmup`` points at an existing file — the warm-start effect on the
first query. The graph lives on ``--device`` (default ``cuda``, which
raises without a card; ``--device cpu`` runs the plain PyTorch path).
Injected faults degrade to a fallback backend; a kernel that does not
build or launch stops the run with its error.
"""

from __future__ import annotations

import argparse
import os
import time
from typing import List, Optional

import numpy as np


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=512, help="graph nodes")
    ap.add_argument("--scale", type=int, default=None,
                    help="R-MAT scale: n = 2**scale (overrides --n)")
    ap.add_argument("--tile-dim", type=int, default=32)
    ap.add_argument("--backend", default="b2sr_cuda",
                    choices=("b2sr", "b2sr_cuda", "csr"))
    ap.add_argument("--device", default="cuda",
                    help="device of the graph (cuda raises without a card)")
    ap.add_argument("--queries", type=int, default=96,
                    help="total queries to serve")
    ap.add_argument("--budget-ms", type=float, default=100.0,
                    help="per-query latency budget")
    ap.add_argument("--arrival-batch", type=int, default=4,
                    help="queries admitted between polls")
    ap.add_argument("--fault-rate", type=float, default=0.0,
                    help="injected failure rate on the graph's backend")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--warmup", default="",
                    help="warmup file to replay at startup (if it exists)")
    ap.add_argument("--save-warmup", default="",
                    help="persist the served plan recipes here on exit")
    ap.add_argument("--metrics-out", default="",
                    help="write the metrics registry here on exit "
                         "(.prom -> Prometheus text, else JSON)")
    ap.add_argument("--trace-out", default="",
                    help="write completed-query trace spans here (JSONL)")
    ap.add_argument("--stats-every", type=int, default=0,
                    help="print a server stats line every N queries")
    ap.add_argument("--cost-accounting", action="store_true",
                    help="attach counted FLOPs/bytes to new plans "
                         "(runs each plan's first call twice)")
    args = ap.parse_args(argv)

    from repro_torch.core.graphblas import GraphMatrix
    from repro_torch.data import graphs as G
    from repro_torch.engine import (FaultInjector, GraphQueryServer,
                                    PlanCache, QueryRejected, ServerConfig)
    from repro_torch.obs import cost as obs_cost
    from repro_torch.obs import export as obs_export
    from repro_torch.obs import metrics as obs_metrics

    if args.cost_accounting:
        obs_cost.set_cost_accounting(True)

    n = 1 << args.scale if args.scale is not None else args.n
    rows, cols = G.rmat_graph(n, avg_degree=8, seed=args.seed,
                              symmetric=False)
    g = GraphMatrix.from_coo(rows, cols, n, n, tile_dim=args.tile_dim,
                             backend=args.backend, device=args.device)

    injector = None
    if args.fault_rate > 0:
        injector = FaultInjector(seed=args.seed).fail(
            backend=args.backend, rate=args.fault_rate)
    server = GraphQueryServer(
        planner=PlanCache(),
        config=ServerConfig(default_budget_s=args.budget_ms / 1e3,
                            backoff_base_s=1e-3),
        fault_injector=injector)
    server.register(g)

    warm_replayed = 0
    if args.warmup and os.path.exists(args.warmup):
        t0 = time.perf_counter()
        warm_replayed = server.warmup(args.warmup)
        print(f"warmup: replayed {warm_replayed} plan recipes in "
              f"{time.perf_counter() - t0:.2f}s from {args.warmup}")

    rng = np.random.default_rng(args.seed)
    kinds = ("bfs", "khop", "sssp", "ppr")
    kind_params = {"bfs": {}, "khop": {"k": 2},
                   "sssp": {"edge_weight": 1.0},
                   "ppr": {"max_iters": 5, "eps": 0.0}}
    submitted = []
    t_first = None
    t_start = time.monotonic()
    for i in range(args.queries):
        kind = kinds[i % len(kinds)]
        src = int(rng.integers(0, n))
        t0 = time.monotonic()
        try:
            h = server.submit(g, kind, src, **kind_params[kind])
        except QueryRejected as e:
            print(f"rejected: {e}")
            continue
        submitted.append((kind, src, t0, h))
        if (i + 1) % args.arrival_batch == 0:
            server.poll()
        if t_first is None and submitted and submitted[0][3].done():
            t_first = time.monotonic() - submitted[0][2]
        if args.stats_every and (i + 1) % args.stats_every == 0:
            snap = server.stats()
            c = snap["counters"]
            print(f"[{i + 1}/{args.queries}] completed {c['completed']} | "
                  f"queue {snap['queue_depth']} | "
                  f"degraded {c['degraded_launches']} | "
                  f"plan cache {snap['plan_cache']['hits']}h/"
                  f"{snap['plan_cache']['misses']}m")
    server.flush()
    elapsed = time.monotonic() - t_start
    if t_first is None and submitted:
        t_first = (submitted[0][3].completed_at or time.monotonic()) \
            - submitted[0][2]

    lat_ms, degraded, failed = [], 0, 0
    for kind, src, t0, h in submitted:
        try:
            h.result()
        except Exception:                    # noqa: BLE001 — counted below
            failed += 1
            continue
        if h.completed_at is not None:
            lat_ms.append((h.completed_at - t0) * 1e3)
        degraded += int(h.degraded)

    s = server.stats
    print(f"served {s['completed']}/{len(submitted)} queries in "
          f"{elapsed:.2f}s ({s['completed'] / elapsed:.1f} qps) on "
          f"backend={args.backend} device={g.device} "
          f"fault_rate={args.fault_rate}")
    if lat_ms:
        print(f"latency: first {t_first * 1e3:.1f} ms | "
              f"p50 {np.percentile(lat_ms, 50):.1f} ms | "
              f"p99 {np.percentile(lat_ms, 99):.1f} ms")
    print(f"flushes: {s['flushes']} (deadline {s['deadline_flushes']}, "
          f"fill {s['fill_flushes']}) | deduped {s['deduped']} | "
          f"rejected {s['rejected']}")
    print(f"degraded: {degraded} queries ({s['degraded_launches']} "
          f"launches) | retries {s['retries']} | breaker skips "
          f"{s['breaker_skips']} | failed {failed}")
    print(f"plan cache: {server.planner.misses} builds, "
          f"{server.planner.hits} hits"
          + (f" (after {warm_replayed} warm-replayed)" if warm_replayed
             else ""))

    if args.save_warmup:
        n_saved = server.save_warmup(args.save_warmup)
        print(f"saved {n_saved} plan recipes to {args.save_warmup}")
    if args.metrics_out:
        obs_export.write_metrics(args.metrics_out)
        print(f"wrote metrics registry snapshot to {args.metrics_out}")
    if args.trace_out:
        if obs_metrics.enabled():
            n_traces = server.dump_traces(args.trace_out)
            print(f"wrote {n_traces} query traces to {args.trace_out}")
        else:
            print("trace-out skipped: observability is disabled")


if __name__ == "__main__":
    main()
