"""PyTorch port vs the JAX reference: the telemetry layer (``obs``).

The same operations go through ``repro.obs`` and ``repro_torch.obs`` and
must leave the same registry: snapshots, Prometheus text and exported
files equal. The dispatch hooks must fire where the reference's do: once
per key per algorithm call or plan build, never on a warm plan (direct
``bfs`` in push and pull, ``msbfs`` first and warm calls; in auto mode
the port resolves only the branch it runs, a deliberate difference pinned
below). ``observe_trace`` and the plan-cache counters must count the
same over the same queries. Then the port alone: spans, the served
trace, the disable switch and cost accounting, whose ``b2sr_cuda``
plans must count their hand kernels' operand bytes. Graphs are small;
``b2sr_cuda`` on a CPU graph runs the kernels' plain versions.
"""

from __future__ import annotations

import functools
import json
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

try:
    import jax.numpy as jnp  # noqa: F401
    from repro.algorithms import bfs as r_bfs
    from repro.algorithms import connected_components as r_cc
    from repro.core import dispatch as r_dispatch
    from repro.core.graphblas import GraphMatrix as RGraph
    from repro.engine import queries as RQ
    from repro.engine.planner import PlanCache as RPlanCache
    from repro.obs import export as r_export
    from repro.obs import metrics as r_metrics
except ImportError:                      # a card's machine without JAX
    RGraph = None

from repro_torch import obs  # noqa: E402
from repro_torch.algorithms import bfs, connected_components  # noqa: E402
from repro_torch.algorithms import direction as direction_mod  # noqa: E402
from repro_torch.core import dispatch  # noqa: E402
from repro_torch.core.graphblas import GraphMatrix  # noqa: E402
from repro_torch.data import graphs as PG  # noqa: E402
from repro_torch.engine import (FaultInjector, GraphQueryServer,  # noqa: E402
                                PlanCache, batched_ppr, msbfs, mskhop,
                                plan_key)
from repro_torch.obs import cost as obs_cost  # noqa: E402
from repro_torch.obs import export as obs_export  # noqa: E402
from repro_torch.obs import metrics as obs_metrics  # noqa: E402
from repro_torch.obs import trace as obs_trace  # noqa: E402

needs_reference = pytest.mark.skipif(
    RGraph is None, reason="the JAX reference package needs jax")

N = 64
#: port backend -> the reference backend it is held against
REF_BACKEND = {"b2sr": "b2sr", "b2sr_cuda": "b2sr_pallas", "csr": "csr"}


@functools.lru_cache(maxsize=None)
def coo(seed: int = 1):
    return PG.rmat_graph(N, avg_degree=6, seed=seed)


def port_graph(backend: str, seed: int = 1, t: int = 8) -> GraphMatrix:
    r, c = coo(seed)
    return GraphMatrix.from_coo(r, c, N, N, tile_dim=t, backend=backend,
                                device="cpu")


def ref_graph(backend: str, seed: int = 1, t: int = 8):
    r, c = coo(seed)
    return RGraph.from_coo(r, c, N, N, tile_dim=t, backend=backend)


@pytest.fixture(autouse=True)
def fresh_registry():
    """Every test runs against fresh registries in both packages, with
    observability on."""
    reg = obs_metrics.MetricsRegistry()
    prev = obs_metrics.set_registry(reg)
    prev_on = obs_metrics.set_enabled(True)
    if RGraph is not None:
        rreg = r_metrics.MetricsRegistry()
        rprev = r_metrics.set_registry(rreg)
        rprev_on = r_metrics.set_enabled(True)
    yield reg
    obs_metrics.set_enabled(prev_on)
    obs_metrics.set_registry(prev)
    if RGraph is not None:
        r_metrics.set_enabled(rprev_on)
        r_metrics.set_registry(rprev)


def ref_registry():
    return r_metrics.get_registry()


# -- the registry against the reference's -------------------------------------

def _drive(metrics_mod, clock):
    """One sequence of registry operations; returns the registry."""
    reg = metrics_mod.MetricsRegistry(max_events=3, clock=clock)
    c = reg.counter("reqs_total", "requests", ("kind", "ok"))
    c.inc(kind="bfs", ok=True)
    c.inc(2.5, kind="bfs", ok="True")
    c.inc(kind="ppr", ok=False)
    reg.gauge("depth", "queue").set(7)
    reg.gauge("depth", "queue").dec(2)
    h = reg.histogram("lat_s", "latency", ("op",), buckets=(1e-3, 0.1, 1.0))
    for v in (5e-4, 0.05, 0.05, 2.0, 0.7, 1e-3):
        h.observe(v, op="bfs")
    h.observe(0.2, op="ppr")
    for i in range(5):
        reg.event("tick", i=i)
    with pytest.raises(ValueError):
        c.inc(kind="bfs")                    # a missing label
    with pytest.raises(ValueError):
        reg.gauge("reqs_total")              # another kind, same name
    return reg


@needs_reference
def test_registry_snapshot_and_prometheus_match_reference(tmp_path):
    ours = _drive(obs_metrics, clock=lambda: 123.0)
    theirs = _drive(r_metrics, clock=lambda: 123.0)
    assert ours.snapshot() == theirs.snapshot()
    assert ours.to_json(indent=1) == theirs.to_json(indent=1)
    text = ours.to_prometheus()
    assert text == theirs.to_prometheus()
    assert obs_export.parse_prometheus(text) == \
        r_export.parse_prometheus(text)
    assert [e["i"] for e in ours.events("tick")] == [2, 3, 4]   # bounded
    assert ours.get("lat_s").quantile(0.5, op="bfs") == 0.05
    # the files: one written by each package, read back by the other
    for ext in ("prom", "json"):
        mine = obs_export.write_metrics(str(tmp_path / f"m.{ext}"), ours)
        ref = r_export.write_metrics(str(tmp_path / f"r.{ext}"), theirs)
        assert open(mine).read() == open(ref).read()
    parsed = obs_export.parse_prometheus(open(tmp_path / "r.prom").read())
    assert parsed["reqs_total"]['{kind="bfs",ok="True"}'] == 3.5
    assert parsed["lat_s_bucket"]['{op="bfs",le="+Inf"}'] == 6
    assert json.load(open(tmp_path / "m.json"))["gauges"]["depth"][""] == 5


def test_span_nesting_annotation_and_errors():
    tr = obs_trace.Trace("t")
    with tr.span("outer", who="me") as outer:
        with tr.span("inner") as inner:
            inner.set(deep=True)
    assert tr.span_names() == ["outer", "inner"] and outer.children == [inner]
    assert abs(tr.total_exclusive_s() - outer.duration_s) < 1e-9
    with pytest.raises(RuntimeError):
        with tr.span("boom"):
            raise RuntimeError("kaput")
    assert "kaput" in tr.find("boom")[0].attrs["error"]
    assert obs_trace.current_span("x") is obs_trace.NOOP_SPAN
    with obs_trace.use(tr):
        with obs_trace.current_span("stage"):
            obs_trace.annotate(tagged=True)
    assert tr.find("stage")[0].attrs == {"tagged": True}
    assert tr.to_dict()["spans"][0]["spans"][0]["name"] == "inner"


# -- dispatch hooks: where they fire ------------------------------------------

def _hooked(dispatch_mod, fn):
    """The keys the resolve hook saw while ``fn`` ran."""
    keys = []
    prev = dispatch_mod.set_resolve_hook(keys.append)
    try:
        fn()
    finally:
        dispatch_mod.set_resolve_hook(prev)
    return keys


def _resolves(reg):
    return reg.snapshot()["counters"].get("dispatch_resolves_total", {})


def _ref_labels(counts, backend):
    """The reference's series with its backend named as the port's."""
    return {k.replace(f'backend="{REF_BACKEND[backend]}"',
                      f'backend="{backend}"'): v for k, v in counts.items()}


@needs_reference
@pytest.mark.parametrize("backend", ("b2sr", "b2sr_cuda"))
@pytest.mark.parametrize("direction", ("push", "pull"))
def test_resolve_hooks_match_reference(fresh_registry, backend, direction):
    """Direct bfs: one resolution per key per call, in both packages; an
    msbfs plan's first call resolves its row once, a warm call nothing."""
    g, rg = port_graph(backend), ref_graph(REF_BACKEND[backend])
    mine = _hooked(dispatch, lambda: bfs(g, 1, direction=direction))
    ref = _hooked(r_dispatch, lambda: r_bfs(rg, 1, direction=direction))
    op = "mxv" if direction == "push" else "mxv_pull"
    assert mine == [(op, "bitvec", "bin", backend, True, True, False)]
    assert [k[:3] + k[4:] for k in ref] == [k[:3] + k[4:] for k in mine]
    assert _resolves(fresh_registry) == _ref_labels(
        _resolves(ref_registry()), backend)
    pc, rpc = PlanCache(), RPlanCache()
    for call in ("first", "warm"):
        mine = _hooked(dispatch, lambda: msbfs(g, [0, 3], planner=pc,
                                               direction=direction))
        ref = _hooked(r_dispatch, lambda: RQ.msbfs(
            rg, [0, 3], planner=rpc, direction=direction))
        assert [k[:3] + k[4:] for k in mine] == [k[:3] + k[4:] for k in ref]
        assert len(mine) == (1 if call == "first" else 0)
    assert _resolves(fresh_registry) == _ref_labels(
        _resolves(ref_registry()), backend)
    hist = fresh_registry.snapshot()["histograms"]["dispatch_resolve_s"]
    assert sum(s["count"] for s in hist.values()) == 2


@needs_reference
def test_auto_resolves_only_the_branch_it_runs():
    """A deliberate difference: the reference traces both branches of its
    auto loop and resolves push and pull once each; the port resolves the
    rows of the iterations it runs, each once per call."""
    g, rg = port_graph("b2sr"), ref_graph("b2sr")
    # one iteration: auto runs push only
    mine = _hooked(dispatch, lambda: bfs(g, 0, max_iters=1,
                                         direction="auto"))
    ref = _hooked(r_dispatch, lambda: r_bfs(rg, 0, max_iters=1,
                                            direction="auto"))
    assert [k[0] for k in mine] == ["mxv"]
    assert sorted(k[0] for k in ref) == ["mxv", "mxv_pull"]
    res = bfs(g, 0, direction="auto")
    assert "pull" in res.directions and res.directions.count("push") > 1
    mine = _hooked(dispatch, lambda: bfs(g, 0, direction="auto"))
    assert sorted(k[0] for k in mine) == ["mxv", "mxv_pull"]


def test_observe_hook_sees_aborted_resolutions(fresh_registry):
    inj = FaultInjector(seed=0).fail(script=[True])   # every op/backend
    with inj:
        with pytest.raises(dispatch.InjectedFault, match="injected fault"):
            msbfs(port_graph("b2sr_cuda", seed=3), [0, 1],
                  planner=PlanCache())
    faults = fresh_registry.snapshot()["counters"]["dispatch_faults_total"]
    assert sum(faults.values()) == 1
    assert all('error="InjectedFault"' in k for k in faults)
    ev, = fresh_registry.events("dispatch_fault")
    assert "injected fault" in ev["error"]
    assert dispatch.set_resolve_hook(None) is None     # fully unhooked


# -- observe_trace and the plan-cache counters against the reference ----------

@needs_reference
def test_observe_trace_counters_match_reference(fresh_registry):
    g, rg = port_graph("b2sr"), ref_graph("b2sr")
    for s in (0, 1, 7):
        bfs(g, s, direction="auto")
        r_bfs(rg, s, direction="auto")
    connected_components(g)
    r_cc(rg)
    msbfs(g, [0, 5, 9], planner=PlanCache())
    RQ.msbfs(rg, [0, 5, 9], planner=RPlanCache())
    mine, ref = fresh_registry.snapshot(), ref_registry().snapshot()
    for name in ("traversal_iterations_total", "direction_switches_total"):
        assert mine["counters"][name] == ref["counters"][name]
    strip = [{k: v for k, v in e.items() if k != "ts"}
             for e in mine["events"] if e["event"] == "direction_switch"]
    assert strip == [{k: v for k, v in e.items() if k != "ts"}
                     for e in ref["events"]
                     if e["event"] == "direction_switch"]
    assert mine["counters"]["traversal_iterations_total"][
        '{direction="push",kernel="msbfs"}'] >= 1
    direction_mod.observe_trace(("push", "pull", "push"), kernel="cc")
    assert fresh_registry.counter(
        "direction_switches_total", "", ("transition",)).value(
        transition="pull->push") >= 1


@needs_reference
@pytest.mark.parametrize("backend", ("b2sr_cuda", "csr"))
def test_plan_cache_counters_match_reference(fresh_registry, backend):
    g, rg = port_graph(backend), ref_graph(REF_BACKEND[backend])
    pc, rpc = PlanCache(capacity=2), RPlanCache(capacity=2)
    for sources in ([0], [3, 4], list(range(40)), [9]):
        msbfs(g, sources, planner=pc)
        RQ.msbfs(rg, sources, planner=rpc)
    for k in (1, 2):
        mskhop(g, [2], k, planner=pc)
        RQ.mskhop(rg, [2], k, planner=rpc)
    batched_ppr(g, [1, 2], max_iters=3, planner=pc)
    RQ.batched_ppr(rg, [1, 2], max_iters=3, planner=rpc)
    assert pc.stats() == rpc.stats()
    mine, ref = fresh_registry.snapshot(), ref_registry().snapshot()
    for what in ("hits", "misses", "evictions"):
        name = f"plan_cache_{what}_total"
        assert mine["counters"][name] == _ref_labels(ref["counters"][name],
                                                     backend)
    lat = mine["histograms"]["launch_latency_s"]
    assert sum(s["count"] for s in lat.values()) == sum(
        s["count"] for s in ref["histograms"]["launch_latency_s"].values())


# -- the instrumented serving stack, the switch, cost -------------------------

def test_served_bfs_trace_covers_latency(fresh_registry):
    srv = GraphQueryServer(planner=PlanCache())
    g = port_graph("b2sr_cuda")
    t0 = time.monotonic()
    h = srv.bfs(g, 0)
    h.result()
    observed = h.completed_at - t0
    tr = h.trace
    assert {"submit", "queue_wait", "launch", "plan_resolve",
            "scatter_back"} <= set(tr.span_names())
    resolve, = tr.find("plan_resolve")
    launch, = tr.find("launch")
    assert resolve in launch.children and resolve.attrs["cache_hit"] is False
    assert launch.attrs["first_call"] is True
    covered = tr.total_exclusive_s()
    assert abs(covered - observed) <= 0.10 * observed, (covered, observed)
    assert tr.attrs["backend_used"] == "b2sr_cuda"
    assert tr.attrs["degraded"] is False
    h2 = srv.bfs(g, 1)
    h2.result()
    assert h2.trace.find("plan_resolve")[0].attrs["cache_hit"] is True
    assert h2.trace.find("launch")[0].attrs["first_call"] is False
    snap = fresh_registry.snapshot()
    assert sum(snap["counters"]["plan_cache_misses_total"].values()) == 1
    assert sum(snap["counters"]["plan_cache_hits_total"].values()) == 1
    assert sum(snap["counters"]["server_queries_completed_total"]
               .values()) == 2
    assert snap["counters"]["engine_launches_total"][
        '{kind="bfs",backend="b2sr_cuda"}'] == 2
    assert sum(s["count"] for s in
               snap["histograms"]["launch_latency_s"].values()) == 2


def test_disabled_mode_records_nothing(fresh_registry):
    with obs.disabled():
        assert not obs_metrics.enabled()
        assert obs_trace.new_trace() is None
        assert obs_trace.Trace("manual").span("x") is obs_trace.NOOP_SPAN
        srv = GraphQueryServer(planner=PlanCache())
        g = port_graph("b2sr_cuda", seed=8)
        h = srv.bfs(g, 0)
        assert int(h.result()[0]) == 0
        assert h.trace is None and len(srv.trace_log) == 0
        bfs(g, 1)
        connected_components(g)
        assert srv.stats["completed"] == 1
        assert srv.stats()["plan_cache"]["misses"] == 1
    assert obs_metrics.enabled()
    snap = fresh_registry.snapshot()
    assert snap["counters"] == {} and snap["gauges"] == {}
    assert snap["histograms"] == {} and snap["events"] == []


def _kernel_bytes(g, op):
    """What the hand kernels of one ``op`` launch must count at least: the
    B2SR arrays of the orientation it walks."""
    m = g.transposed().b2sr if op in ("msbfs", "mskhop", "ppr") else g.b2sr
    return obs_cost.nbytes(m.tile_row_ptr, m.tile_col_idx, m.bit_tiles)


@pytest.mark.parametrize("backend", ("b2sr_cuda", "b2sr"))
def test_plan_cost_accounting_and_roofline(fresh_registry, backend):
    prev = obs_cost.set_cost_accounting(True)
    try:
        pc = PlanCache()
        g = port_graph(backend, seed=6)
        msbfs(g, [0, 1], planner=pc, direction="push")
        mskhop(g, [4], 2, planner=pc)
        batched_ppr(g, [2], max_iters=3, eps=0.0, planner=pc)
        msbfs(g, [5, 1], planner=pc, direction="push")    # warm: no count
        key, = [k for k in pc.keys() if k.kernel == "msbfs"]
        assert key == plan_key(g, "msbfs", 32, desc=key.desc)
        rows = {r["op"]: r for r in obs_cost.roofline_table(fresh_registry)}
        assert set(rows) == {"msbfs", "mskhop", "ppr"}
        assert rows["msbfs"]["n_launches"] == 2
        for k in pc.keys():
            cost = pc.get(k, lambda: None).cost
            assert cost["wire_bytes"] == 0 and cost["compile_s"] > 0
            assert cost["hbm_bytes"] >= cost["aten_bytes"] > 0
            kern = cost["kernels"]
            if backend == "b2sr":
                assert kern == {}            # the torch word schemes
                continue
            name = "spmm_dense" if k.kernel == "ppr" else "spmm_bbb"
            assert set(kern) == {name} and kern[name]["launches"] >= 1
            # every launch counts the operands it was handed
            assert kern[name]["bytes"] >= kern[name]["launches"] * \
                _kernel_bytes(g, k.kernel)
            assert kern[name]["ops"] > 0
            row = rows[k.kernel]
            assert row["est_hbm_bytes"] == cost["hbm_bytes"]
            assert row["est_hbm_bytes"] >= kern[name]["bytes"] + \
                cost["aten_bytes"]
            assert row["achieved_hbm_bytes_s"] > 0
        gauges = fresh_registry.snapshot()["gauges"]
        assert len(gauges["plan_hbm_bytes"]) == 3
    finally:
        obs_cost.set_cost_accounting(prev)


#: A 16-node graph in 4x4 tiles: tiles (0,0), (0,1), (1,0), (2,3), (3,2),
#: (3,3); 7 edges. Its B2SR holds 5 + 6 + 6 * 4 int32 words: 140 bytes.
FIXED_EDGES = ((0, 1), (1, 0), (2, 5), (5, 2), (9, 14), (14, 9), (15, 15))


def _fixed_b2sr():
    from repro_torch.core.b2sr import coo_to_b2sr
    r, c = zip(*FIXED_EDGES)
    m = coo_to_b2sr(np.array(r), np.array(c), 16, 16, tile_dim=4,
                    device="cpu")
    assert (m.n_tiles, m.nnz) == (6, 7)
    return m


def _counted_call(name, m):
    """One call of the counted wrapper ``name`` on the fixed graph, D = 3
    columns (W = 1 frontier word)."""
    from repro_torch.kernels.bitpack import bitpack
    from repro_torch.kernels.spmm import spmm
    rng = np.random.default_rng(0)
    if name == "spmm_bbb":
        f = torch.from_numpy(rng.integers(-2**31, 2**31, (4, 4, 1),
                                          dtype=np.int32))
        return spmm.spmm_bbb(m, f, torch.zeros_like(f))
    if name == "spmm_dense":
        return spmm.spmm_dense(m, torch.from_numpy(
            rng.random((16, 3), dtype=np.float32)))
    if name == "spmm_bbf":
        return spmm.spmm_bbf(m, torch.from_numpy(
            rng.integers(-2**31, 2**31, (4, 3), dtype=np.int32)))
    return bitpack.pack_rows(torch.from_numpy(rng.random((16, 3)) > 0.5), 4)


#: Each counted kernel's bytes and operations on the fixed graph, by hand:
#: A is 140 bytes; spmm_bbb reads f and the mask and writes Y (3 x 64 B),
#: an AND and an OR per tile word (24) and frontier word; spmm_dense reads
#: X and writes Y (2 x 192 B), a multiply and an add per edge and column;
#: spmm_bbf reads 12 words and writes 48 floats, AND, popcount and add per
#: tile word and column; pack_rows reads 48 bools and writes 12 words, a
#: test and an OR per entry.
COUNTED_COST = {"spmm_bbb": (140 + 3 * 64, 2 * 24 * 1),
                "spmm_dense": (140 + 2 * 192, 2 * 7 * 3),
                "spmm_bbf": (140 + 48 + 192, 3 * 24 * 3),
                "pack_rows": (48 + 48, 2 * 48)}


@pytest.mark.parametrize("name", sorted(COUNTED_COST))
def test_counted_kernel_cost_is_exact(name):
    m = _fixed_b2sr()
    want = _counted_call(name, m)          # uncounted: the same output
    cost = obs_cost.analyze_plan(_counted_call, (name, m), {})
    n_bytes, ops = COUNTED_COST[name]
    assert cost["kernels"] == {name: {"launches": 1, "bytes": n_bytes,
                                      "ops": ops}}
    # the wrapper's plain version counts nothing twice through aten
    assert cost["hbm_bytes"] == cost["aten_bytes"] + n_bytes
    assert cost["flops"] == ops
    assert torch.equal(_counted_call(name, m), want)


def test_cost_accounting_off_by_default(fresh_registry):
    pc = PlanCache()
    msbfs(port_graph("b2sr_cuda", seed=7), [0], planner=pc)
    assert pc.get(pc.keys()[0], lambda: None).cost is None
    assert fresh_registry.get("plan_flops") is None
    assert obs_cost.roofline_table(fresh_registry) == []
