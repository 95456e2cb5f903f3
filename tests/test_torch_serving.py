"""PyTorch port vs the JAX reference: the serving front end.

Deadlines, fill flushes, admission control, circuit breakers, the
fallback chain, fault injection and warmup, held against
``repro.engine.server`` on the same inputs at the sizes
``tests/test_serving.py`` uses: breaker transitions under a fake clock,
the faults the same seeded rules fire, the scripted breaker scenario
through the server (the reference on ``b2sr_pallas`` in interpret mode,
the port on ``b2sr_cuda``, whose kernels run their plain versions on a
CPU graph) with equal outcomes, counters and levels, and warmup files
that load in either package. Then the port alone: bit-exact
degradation, dedup, idempotent failures and the ``serve_queries``
launcher at n = 128 on the host.
"""

from __future__ import annotations

import functools
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

try:
    import jax.numpy as jnp  # noqa: F401
    from repro.core.graphblas import GraphMatrix as RGraph
    from repro.engine import FaultInjector as RFaultInjector
    from repro.engine import GraphQueryServer as RServer
    from repro.engine import PlanCache as RPlanCache
    from repro.engine import ServerConfig as RServerConfig
    from repro.engine import warmup as r_warmup
    from repro.engine.server import CircuitBreaker as RBreaker
except ImportError:                      # a card's machine without JAX
    RGraph = None

from repro_torch.algorithms import bfs, khop_frontier, sssp  # noqa: E402
from repro_torch.core import dispatch  # noqa: E402
from repro_torch.core.graphblas import GraphMatrix  # noqa: E402
from repro_torch.engine import (CircuitBreaker, FaultInjector,  # noqa: E402
                                GraphQueryServer, InjectedFault, PlanCache,
                                QueryBatcher, QueryGroupError, QueryRejected,
                                ServerConfig, batched_ppr)
from repro_torch.engine import warmup as warmup_mod  # noqa: E402
from repro_torch.engine.server import (CLOSED, HALF_OPEN,  # noqa: E402
                                       OPEN)
from repro_torch.launch import serve_queries  # noqa: E402

needs_reference = pytest.mark.skipif(
    RGraph is None, reason="the JAX reference package needs jax")


def skewed_coo(n, seed, hub_deg=15, base_deg=3):
    """The reference test's graph: 3 out-edges a node and two hubs."""
    rng = np.random.default_rng(seed)
    rows = np.concatenate([
        np.repeat(np.arange(n, dtype=np.int64), base_deg),
        np.repeat(rng.choice(n, 2, replace=False).astype(np.int64), hub_deg),
    ])
    cols = rng.integers(0, n, rows.size)
    return rows, cols


@functools.lru_cache(maxsize=None)
def build(n=64, t=8, backend="b2sr", seed=0, use_buckets=True):
    rows, cols = skewed_coo(n, seed)
    g = GraphMatrix.from_coo(rows, cols, n, n, tile_dim=t, backend=backend,
                             device="cpu")
    return g.with_buckets(use_buckets)


def ref_build(n=64, t=8, backend="b2sr", seed=0):
    rows, cols = skewed_coo(n, seed)
    return RGraph.from_coo(rows, cols, n, n, tile_dim=t, backend=backend)


class FakeClock:
    def __init__(self, t=100.0):
        self.t = t

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


def make_server(clock=None, injector=None, cls=GraphQueryServer,
                cfg_cls=ServerConfig, planner_cls=PlanCache, **cfg_kw):
    cfg_kw.setdefault("backoff_base_s", 0.0)
    return cls(planner=planner_cls(), config=cfg_cls(**cfg_kw),
               fault_injector=injector,
               clock=clock if clock is not None else FakeClock(),
               sleep=lambda s: None)


def levels(h):
    return np.asarray(h.result())


# -- deadline-aware admission -------------------------------------------------

def test_deadline_flush_fires_when_oldest_budget_nears():
    clk = FakeClock()
    srv = make_server(clock=clk, default_budget_s=0.1, flush_margin_s=0.005)
    g = build()
    h1 = srv.bfs(g, 3)
    clk.advance(0.050)
    h2 = srv.bfs(g, 7, budget_s=0.2)
    assert srv.poll() == 0 and srv.pending() == 2
    clk.advance(0.044)                       # oldest deadline 6 ms away
    assert not srv.due() and srv.poll() == 0
    clk.advance(0.002)                       # 4 ms away: inside the margin
    assert srv.due() and srv.poll() == 2
    assert h1.done() and h2.done() and srv.pending() == 0
    assert srv.stats["deadline_flushes"] == 1
    assert srv.stats["fill_flushes"] == 0
    assert np.array_equal(levels(h1), bfs(g, 3).levels.numpy())
    assert h1.completed_at == clk.t and h1.deadline == 100.1
    assert not h1.degraded and h1.backend_used == "b2sr"


def test_fill_flush_queue_bound_and_validation():
    srv = make_server(max_batch=4, max_queue=5)
    g = build()
    handles = [srv.bfs(g, s) for s in (1, 2, 3)]
    assert srv.pending() == 3 and not handles[0].done()
    handles.append(srv.bfs(g, 4))            # the 4th submit fills a batch
    assert srv.pending() == 0 and all(h.done() for h in handles)
    assert srv.stats["fill_flushes"] == 1
    for s, h in zip((1, 2, 3, 4), handles):
        assert np.array_equal(levels(h), bfs(g, s).levels.numpy())
    small = make_server(max_queue=2)
    h1, h2 = small.bfs(g, 1), small.bfs(g, 2)
    with pytest.raises(QueryRejected, match=r"queue full \(2/2 pending\)"):
        small.bfs(g, 3)
    assert small.stats["rejected"] == 1 and small.pending() == 2
    small.flush()
    assert np.array_equal(levels(h2), bfs(g, 2).levels.numpy())
    with pytest.raises(ValueError, match=r"graph with 64 nodes.*0\.\.63"):
        small.bfs(g, 64)
    with pytest.raises(ValueError, match="unknown query kind 'pagerank'"):
        small.submit(g, "pagerank", 0)
    with pytest.raises(ValueError, match=r"graph with 64 nodes"):
        QueryBatcher().bfs(g, -1)
    assert small.stats["submitted"] == 2


# -- breakers and injected faults against the reference -----------------------

def _breaker_log(cls):
    clk = FakeClock()
    seen = []
    br = cls(fail_threshold=2, cooldown_s=1.0, clock=clk,
             on_transition=lambda o, n, ts: seen.append((o, n, ts)))
    steps = []
    for op, dt in (("fail", 0), ("allow", 0), ("fail", 0), ("allow", 0.999),
                   ("allow", 0.001), ("fail", 0), ("allow", 1.0),
                   ("success", 0), ("fail", 0), ("allow", 0)):
        clk.advance(dt)
        if op == "allow":
            steps.append(br.allow())
        else:
            getattr(br, f"record_{'failure' if op == 'fail' else 'success'}")()
        steps.append(br.state)
    return steps, br.stats(), seen


@needs_reference
def test_breaker_transitions_match_reference():
    steps, stats, seen = _breaker_log(CircuitBreaker)
    assert (steps, stats, seen) == _breaker_log(RBreaker)
    assert stats["n_opens"] == 2 and stats["state"] == CLOSED
    assert [(o, n) for o, n, _ in seen] == [
        (CLOSED, OPEN), (OPEN, HALF_OPEN), (HALF_OPEN, OPEN),
        (OPEN, HALF_OPEN), (HALF_OPEN, CLOSED)]


def _fault_sequence(cls, seed):
    inj = (cls(seed=seed).fail(op="bfs", rate=0.3)
           .fail(op="ppr", backend="b2sr", rate=0.6)
           .fail(backend="csr", script=[True, False, True]))
    out = []
    for i in range(60):
        op, backend = [("bfs", "b2sr"), ("ppr", "b2sr"), ("khop", "csr"),
                       ("ppr", "csr"), ("sssp", "b2sr")][i % 5]
        try:
            inj.check(op, backend)
            out.append(False)
        except Exception as e:               # noqa: BLE001 — the verdict
            assert type(e).__name__ == "InjectedFault"
            out.append(True)
    return out, inj.n_checks, inj.n_faults, inj.script_remaining("*", "csr")


@needs_reference
@pytest.mark.parametrize("seed", (0, 5))
def test_fault_sequence_matches_reference(seed):
    mine = _fault_sequence(FaultInjector, seed)
    assert mine == _fault_sequence(RFaultInjector, seed)
    assert any(mine[0]) and not all(mine[0])


def _scripted_scenario(g, fast, cls, cfg_cls, inj_cls, planner_cls):
    """test_serving's scripted breaker scenario: 4 faults on bfs/``fast``;
    the answers fall to b2sr, the breaker opens, skips, half-opens,
    re-opens and closes. Returns each step's outcome and the end state."""
    clk = FakeClock()
    inj = inj_cls(seed=0).fail(op="bfs", backend=fast,
                               script=[True, True, True, True])
    srv = make_server(clock=clk, injector=inj, cls=cls, cfg_cls=cfg_cls,
                      planner_cls=planner_cls, max_retries=1,
                      fail_threshold=2, cooldown_s=1.0)
    steps = []
    for dt in (0.0, 0.0, 1.0, 1.0, 1.0):
        clk.advance(dt)
        h = srv.bfs(g, 3)
        srv.flush()
        br = srv.breaker("bfs", fast)
        steps.append((h.degraded, h.backend_used == fast, br.state,
                      br.n_opens, inj.script_remaining("bfs", fast),
                      levels(h).tolist()))
    return steps, dict(srv.stats), srv.breaker("bfs", fast).stats()


@needs_reference
def test_scripted_breaker_scenario_matches_reference():
    g = build(backend="b2sr_cuda")
    mine = _scripted_scenario(g, "b2sr_cuda", GraphQueryServer, ServerConfig,
                              FaultInjector, PlanCache)
    ref = _scripted_scenario(ref_build(backend="b2sr_pallas"),
                             "b2sr_pallas", RServer, RServerConfig,
                             RFaultInjector, RPlanCache)
    assert mine == ref
    steps, stats, br = mine
    assert [s[:5] for s in steps] == [
        (True, False, OPEN, 1, 2), (True, False, OPEN, 1, 2),
        (True, False, OPEN, 2, 1), (True, False, OPEN, 3, 0),
        (False, True, CLOSED, 3, 0)]
    assert stats["retries"] == 1 and stats["breaker_skips"] == 1
    assert stats["degraded_launches"] == 4 and stats["completed"] == 5
    want = bfs(g.with_backend("b2sr"), 3).levels.tolist()
    assert all(s[5] == want for s in steps)


@needs_reference
@pytest.mark.parametrize("writer", ("port", "reference"))
def test_warmup_file_loads_in_the_other_package(tmp_path, writer):
    path = str(tmp_path / "warm.json")
    if writer == "port":
        srv, g = make_server(), build(seed=3)
    else:
        srv = make_server(cls=RServer, cfg_cls=RServerConfig,
                          planner_cls=RPlanCache)
        g = ref_build(seed=3)
    for s in (1, 9):
        srv.bfs(g, s)
    srv.ppr(g, 5, max_iters=3, eps=0.0)
    srv.khop(g, 2, k=2)
    srv.flush()
    assert srv.save_warmup(path) == 3
    mine, ref = warmup_mod.load(path), r_warmup.load(path)
    assert mine == ref and json.load(open(path))["version"] == 1
    assert {r["kind"] for r in mine} == {"bfs", "ppr", "khop"}
    assert all(r["sharded"] is False for r in mine)
    assert sorted(r["width"] for r in mine) == [1, 1, 2]   # pow2 padding
    # a recipe of the other package names a graph this one never hashed:
    # skipped, never fatal
    other = make_server() if writer == "reference" else make_server(
        cls=RServer, cfg_cls=RServerConfig, planner_cls=RPlanCache)
    other.register(build(seed=3) if writer == "reference" else ref_build(
        seed=3))
    assert other.warmup(path) == 0 and other.stats["warmup_skipped"] == 3


# -- the port alone -----------------------------------------------------------

def test_warmup_roundtrip_rebuilds_hot_plans(tmp_path):
    path = str(tmp_path / "warm.json")
    g = build(n=64, seed=3, backend="b2sr_cuda")
    srv = make_server()
    for s in (1, 9):
        srv.bfs(g, s)
    srv.ppr(g, 5, max_iters=3, eps=0.0)
    srv.flush()
    assert srv.save_warmup(path) == 2
    rows, cols = skewed_coo(64, 3)           # a "restart": rebuilt graph
    g2 = GraphMatrix.from_coo(rows, cols, 64, 64, tile_dim=8,
                              backend="b2sr_cuda", device="cpu")
    srv2 = make_server()
    srv2.register(g2)
    assert srv2.warmup(path) == 2 and srv2.planner.misses == 2
    for s in (1, 9):
        srv2.bfs(g2, s)
    srv2.ppr(g2, 5, max_iters=3, eps=0.0)
    srv2.flush()
    assert srv2.planner.misses == 2 and srv2.planner.hits == 2
    sharded = tmp_path / "sharded.json"
    recipes = warmup_mod.load(path)
    warmup_mod.save(str(sharded), [dict(r, sharded=True) for r in recipes])
    assert srv2.warmup(str(sharded)) == 0
    assert srv2.stats["warmup_skipped"] == 2
    with pytest.raises(ValueError, match="missing field"):
        warmup_mod.save(str(tmp_path / "bad.json"), [{"kind": "bfs"}])


@pytest.mark.parametrize("use_buckets", (True, False))
def test_fallback_to_b2sr_is_bit_exact(use_buckets):
    inj = FaultInjector(seed=0).fail(backend="b2sr_cuda", rate=1.0)
    srv = make_server(injector=inj)
    g = build(backend="b2sr_cuda", use_buckets=use_buckets)
    gb = srv._backend_view(g, "b2sr")
    hb, hk = srv.bfs(g, 5), srv.khop(g, 9, k=2)
    hs, hp = srv.sssp(g, 4), srv.ppr(g, 11, max_iters=4, eps=0.0)
    srv.flush()
    for h in (hb, hk, hs, hp):
        assert h.degraded and h.backend_used == "b2sr"
    assert np.array_equal(levels(hb), bfs(gb, 5).levels.numpy())
    assert np.array_equal(levels(hk), khop_frontier(gb, 9, 2).numpy())
    assert np.array_equal(levels(hs), sssp(gb, 4).distances.numpy())
    assert torch.equal(hp.result(), batched_ppr(
        gb, [11], max_iters=4, eps=0.0).ranks[:, 0])
    # the healthy card row gives the same answers
    healthy = make_server()
    hh = [healthy.bfs(g, 5), healthy.khop(g, 9, k=2), healthy.sssp(g, 4)]
    hpp = healthy.ppr(g, 11, max_iters=4, eps=0.0)
    healthy.flush()
    for a, b in zip((hb, hk, hs), hh):
        assert not b.degraded and np.array_equal(levels(a), levels(b))
    assert torch.allclose(hp.result(), hpp.result(), rtol=1e-5, atol=1e-7)
    assert srv.stats["degraded_launches"] == 4 and srv.stats["launches"] == 4
    assert inj.n_faults == 8                 # each group: a try and a retry


def test_fallback_exhausted_fails_handles_idempotently():
    inj = FaultInjector(seed=0).fail(rate=1.0)           # every backend
    srv = make_server(injector=inj, max_retries=1)
    g = build(backend="b2sr_cuda")
    h1, h2 = srv.bfs(g, 1), srv.bfs(g, 2)
    srv.flush()
    assert srv.stats["failed_queries"] == 2 and srv.stats["completed"] == 0
    with pytest.raises(QueryGroupError, match="batched 'bfs' group") as e1:
        h1.result()
    assert isinstance(e1.value.__cause__, InjectedFault)
    for _ in range(2):
        with pytest.raises(QueryGroupError) as e2:
            h1.result()
        assert e2.value is e1.value
    h1._fulfill(np.zeros(3))                 # the first outcome wins
    with pytest.raises(QueryGroupError):
        h2.result()


def test_kernel_error_fails_its_group_and_never_falls_back(monkeypatch,
                                                           tmp_path):
    """A kernel that does not build or launch is a fault of the program,
    not a backend's unavailability: its group fails on b2sr_cuda with no
    retry, no b2sr answer and the breaker untouched, the other groups of
    the flush still run, and the flush raises it; so do a fill flush's
    submit and warmup."""
    from repro_torch.kernels import common
    from repro_torch.kernels.spmm import ref as spmm_ref
    g = build(backend="b2sr_cuda")
    srv = make_server(max_retries=1)
    srv.bfs(g, 1).result()
    warm = str(tmp_path / "w.json")
    assert srv.save_warmup(warm) == 1

    def broken(*args, **kw):
        raise common.KernelError("nvcc failed to build spmm.cu (exit 1)")

    monkeypatch.setattr(spmm_ref, "spmm_bbb", broken)
    h, hp = srv.bfs(g, 2), srv.ppr(g, 3, max_iters=3)
    with pytest.raises(common.KernelError, match="nvcc failed"):
        srv.flush()
    with pytest.raises(QueryGroupError) as e:
        h.result()
    assert isinstance(e.value.__cause__, common.KernelError)
    assert not h.degraded and h.backend_used is None
    assert hp.backend_used == "b2sr_cuda" and hp.result().shape == (64,)
    s = srv.stats
    assert (s["failed_queries"], s["completed"]) == (1, 2)
    assert (s["degraded_launches"], s["retries"]) == (0, 0)
    assert srv.breaker("bfs", "b2sr_cuda").stats()["failures"] == 0
    assert [r.kind for r in srv.launch_log] == ["bfs", "ppr"]
    one = make_server(max_batch=1)
    with pytest.raises(common.KernelError):
        one.bfs(g, 4)                        # the submit's fill flush
    assert one.stats["failed_queries"] == 1 and one.pending() == 0
    boot = make_server()
    boot.register(g)
    with pytest.raises(common.KernelError):
        boot.warmup(warm)


def test_kernel_build_and_launch_failures_raise_kernel_error(monkeypatch,
                                                             tmp_path):
    import sys
    import types
    from repro_torch.kernels import common
    src = tmp_path / "broken.cu"
    src.write_text("this is not CUDA\n")
    monkeypatch.setattr(common, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(common, "find_nvcc", lambda: sys.executable)
    with pytest.raises(common.KernelError, match="nvcc failed to build"):
        common.load_library(src)
    lib = types.SimpleNamespace(
        repro_cuda_error_string=lambda err: b"an illegal memory access")
    with pytest.raises(common.KernelError,
                       match="spmm_bbb: CUDA launch failed with error 700"):
        common.check_launch(lib, 700, "spmm_bbb")


def test_inflight_duplicates_share_one_column():
    srv = make_server()
    g = build(backend="b2sr_cuda")
    dup = [srv.bfs(g, 13) for _ in range(3)]
    other = srv.bfs(g, 2)
    srv.flush()
    assert srv.stats["deduped"] == 2
    want = bfs(g, 13).levels.numpy()
    assert all(np.array_equal(levels(h), want) for h in dup)
    assert np.array_equal(levels(other), bfs(g, 2).levels.numpy())
    assert len(srv.launch_log[-1].sources) == 2


def test_injector_threads_through_dispatch_resolve():
    g = build(backend="b2sr_cuda")
    bfs(g, 1)
    with FaultInjector(seed=0).fail(backend="b2sr_cuda", rate=1.0):
        with pytest.raises(InjectedFault, match="backend 'b2sr_cuda'"):
            bfs(g, 1)
    assert int(bfs(g, 1).levels[1]) == 0     # the hook is gone: healthy
    inj = FaultInjector(seed=0).fail(op="no_such_op", rate=1.0).install()
    try:
        bfs(g, 1)                            # a rule that matches nothing
    finally:
        inj.uninstall()
    assert dispatch.set_resolve_hook(None) is None


def test_serve_queries_launcher_on_the_host(tmp_path, capsys):
    warm, prom = tmp_path / "w.json", tmp_path / "m.prom"
    traces = tmp_path / "t.jsonl"
    args = ["--device", "cpu", "--n", "128", "--tile-dim", "8",
            "--queries", "16", "--seed", "1"]
    serve_queries.main(args + ["--save-warmup", str(warm), "--metrics-out",
                               str(prom), "--trace-out", str(traces)])
    out = capsys.readouterr().out
    assert "served 16/16 queries" in out and "failed 0" in out
    assert len(open(traces).read().splitlines()) == 16
    assert "plan cache: 3 builds, 1 hits" in out   # bfs, sssp share msbfs
    serve_queries.main(args + ["--warmup", str(warm)])
    out = capsys.readouterr().out            # live traffic: hits only
    assert "replayed 4 plan recipes" in out
    assert "plan cache: 3 builds, 5 hits (after 4 warm-replayed)" in out
    serve_queries.main(args + ["--fault-rate", "0.5"])
    out = capsys.readouterr().out
    assert "served 16/16 queries" in out and "failed 0" in out
