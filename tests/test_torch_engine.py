"""PyTorch port vs the JAX reference: the multi-source query engine.

The same numpy-seeded COO and sources go through ``repro.engine`` and
``repro_torch.engine`` on the CPU (``b2sr_cuda`` on a CPU graph runs the
kernels' plain versions), each port backend against its reference twin:
``b2sr`` against ``b2sr``, ``b2sr_cuda`` against ``b2sr_pallas`` (Pallas
in interpret mode), ``csr`` against ``csr``. ``msbfs``, ``mskhop`` and
``ms_sssp`` must be equal bit for bit (levels, iterations and direction
traces included); ``batched_ppr`` within ``atol=1e-5``, the tolerance of
the reference's own engine test. Then the plan cache, the batcher and
the array-source entry points of ``bfs`` and ``sssp``. The test marked
``cuda`` runs the engine on the card and skips here.
"""

from __future__ import annotations

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

try:
    import jax.numpy as jnp  # noqa: F401
    from repro.core.graphblas import GraphMatrix as RGraph
    from repro.engine import queries as RQ
    from repro.engine.planner import PlanCache as RPlanCache
except ImportError:                      # a card's machine without JAX
    RGraph = None

from repro_torch.algorithms import bfs, khop_frontier, ppr, sssp  # noqa: E402
from repro_torch.core.graphblas import GraphMatrix  # noqa: E402
from repro_torch.data import graphs as PG  # noqa: E402
from repro_torch.engine import (BatchFlushError, PlanCache,  # noqa: E402
                                QueryBatcher, QueryGroupError, batched_ppr,
                                ms_sssp, msbfs, mskhop, plan_key)
from repro_torch.engine import batcher as batcher_mod  # noqa: E402
from repro_torch.kernels.spmm import spmm  # noqa: E402

needs_reference = pytest.mark.skipif(
    RGraph is None, reason="the JAX reference package needs jax")

N = 70
SOURCES = (0, 5, 17, 33, 69, 5)          # a duplicate source too
#: (port backend, buckets, reference backend)
BACKEND_CASES = (("b2sr", True, "b2sr"), ("b2sr_cuda", True, "b2sr_pallas"),
                 ("csr", True, "csr"))


@functools.lru_cache(maxsize=None)
def coo():
    return PG.rmat_graph(N, avg_degree=5, seed=3)


@functools.lru_cache(maxsize=None)
def ref_graph(t: int, backend: str, buckets: bool = True):
    r, c = coo()
    return RGraph.from_coo(r, c, N, N, t).with_backend(backend).with_buckets(
        buckets)


@functools.lru_cache(maxsize=None)
def port_graph(t: int, backend: str, buckets: bool = True):
    r, c = coo()
    return GraphMatrix.from_coo(r, c, N, N, t, device="cpu",
                                backend=backend).with_buckets(buckets)


def graphs(t, backend, buckets, ref_backend):
    return ref_graph(t, ref_backend, buckets), port_graph(t, backend, buckets)


# -- the queries against the reference -----------------------------------------

@needs_reference
@pytest.mark.parametrize("direction", ("push", "pull", "auto"))
@pytest.mark.parametrize("backend,buckets,ref_backend", BACKEND_CASES)
@pytest.mark.parametrize("t", (4, 32))
def test_msbfs_matches_reference(t, backend, buckets, ref_backend, direction):
    rg, pg = graphs(t, backend, buckets, ref_backend)
    want = RQ.msbfs(rg, SOURCES, direction=direction, planner=RPlanCache())
    got = msbfs(pg, SOURCES, direction=direction, planner=PlanCache())
    assert got.levels.dtype == torch.int32
    assert np.array_equal(got.levels.numpy(), np.asarray(want.levels))
    assert got.n_iterations == want.n_iterations
    assert got.directions == want.directions
    if direction == "auto":
        assert "pull" in got.directions       # the graph switches


@needs_reference
@pytest.mark.parametrize("backend,buckets,ref_backend", BACKEND_CASES)
def test_msbfs_max_iters_and_wide_batch_match_reference(backend, buckets,
                                                        ref_backend):
    rg, pg = graphs(8, backend, buckets, ref_backend)
    wide = list(range(0, N, 2)) + [1, 3]       # 37 sources: two words
    for srcs, max_iters in ((wide, None), (SOURCES, 2), (SOURCES, 0)):
        want = RQ.msbfs(rg, srcs, max_iters=max_iters, planner=RPlanCache())
        got = msbfs(pg, srcs, max_iters=max_iters, planner=PlanCache())
        assert np.array_equal(got.levels.numpy(), np.asarray(want.levels))
        assert (got.n_iterations, got.directions) == (want.n_iterations,
                                                      want.directions)


@needs_reference
@pytest.mark.parametrize("backend,buckets,ref_backend", BACKEND_CASES)
def test_mskhop_matches_reference(backend, buckets, ref_backend):
    rg, pg = graphs(8, backend, buckets, ref_backend)
    for k in (1, 2, 5):
        want = RQ.mskhop(rg, SOURCES, k, planner=RPlanCache())
        got = mskhop(pg, SOURCES, k, planner=PlanCache())
        assert got.dtype == torch.bool
        assert np.array_equal(got.numpy(), np.asarray(want))
    for i, s in enumerate(SOURCES[:3]):
        assert torch.equal(got[:, i], khop_frontier(pg, s, 5))


@needs_reference
@pytest.mark.parametrize("edge_weight", (1.0, 0.5))
@pytest.mark.parametrize("backend,buckets,ref_backend", BACKEND_CASES)
def test_ms_sssp_matches_reference(backend, buckets, ref_backend,
                                   edge_weight):
    rg, pg = graphs(8, backend, buckets, ref_backend)
    want = RQ.ms_sssp(rg, SOURCES, edge_weight=edge_weight,
                      planner=RPlanCache())
    got = ms_sssp(pg, SOURCES, edge_weight=edge_weight, planner=PlanCache())
    assert np.array_equal(got.distances.numpy(), np.asarray(want.distances))
    assert got.n_iterations == want.n_iterations
    for i, s in enumerate(SOURCES[:3]):
        assert torch.equal(got.distances[:, i],
                           sssp(pg, s, edge_weight=edge_weight).distances)


@needs_reference
@pytest.mark.parametrize("backend,buckets,ref_backend", BACKEND_CASES)
@pytest.mark.parametrize("t", (4, 32))
def test_batched_ppr_matches_reference(t, backend, buckets, ref_backend):
    rg, pg = graphs(t, backend, buckets, ref_backend)
    want = RQ.batched_ppr(rg, SOURCES, planner=RPlanCache())
    got = batched_ppr(pg, SOURCES, planner=PlanCache())
    assert got.n_iterations == want.n_iterations
    np.testing.assert_allclose(got.ranks.numpy(), np.asarray(want.ranks),
                               atol=1e-5, rtol=0)
    for i, s in enumerate(SOURCES[:2]):
        assert torch.allclose(got.ranks[:, i], ppr(pg, s).ranks, atol=1e-5,
                              rtol=0)


@needs_reference
def test_batched_ppr_restart_matrix_and_eps_match_reference():
    rg, pg = graphs(8, "b2sr", True, "b2sr")
    rs = np.random.default_rng(0).random((N, 3)).astype(np.float32)
    rs /= rs.sum(0)
    want = RQ.batched_ppr(rg, rs, max_iters=50, eps=1e-4,
                          planner=RPlanCache())
    got = batched_ppr(pg, rs, max_iters=50, eps=1e-4, planner=PlanCache())
    assert got.n_iterations == want.n_iterations < 50
    np.testing.assert_allclose(got.ranks.numpy(), np.asarray(want.ranks),
                               atol=1e-5, rtol=0)
    with pytest.raises(ValueError, match="restart matrix"):
        batched_ppr(pg, rs[:-1])


def test_sources_are_checked():
    g = port_graph(8, "b2sr")
    for bad in ([], [N], [-1, 3]):
        with pytest.raises(ValueError):
            msbfs(g, bad)
    with pytest.raises(ValueError, match=f"{N}"):
        batched_ppr(g, [0, N])
    with pytest.raises(ValueError, match="k must be"):
        mskhop(g, [0], 0)
    with pytest.raises(ValueError, match="max_iters"):
        msbfs(g, [0], max_iters=-1)


# -- entry points that route batches to the engine ---------------------------------

def test_bfs_and_sssp_take_source_arrays():
    g = port_graph(8, "b2sr_cuda")
    res = bfs(g, np.array([3, 9]), direction="pull")
    assert res.levels.shape == (N, 2)
    for i, s in enumerate((3, 9)):
        assert torch.equal(res.levels[:, i],
                           bfs(g, s, direction="pull").levels)
    d = sssp(g, [3, 9], edge_weight=0.5)
    assert d.distances.shape == (N, 2)
    assert torch.equal(d.distances[:, 1], sssp(g, 9, 0.5).distances)
    with pytest.raises(ValueError, match="row_chunk"):
        bfs(g, [3, 9], row_chunk=1)
    with pytest.raises(ValueError, match="row_chunk"):
        sssp(g, [3, 9], row_chunk=1)
    assert torch.equal(g.msbfs([3, 9]).levels, msbfs(g, [3, 9]).levels)
    assert torch.equal(g.ppr([3]).ranks, batched_ppr(g, [3]).ranks)


# -- the plan cache ---------------------------------------------------------------------

def test_plan_cache_hits_misses_and_lru_eviction():
    g = port_graph(8, "b2sr")
    cache = PlanCache(capacity=2)
    msbfs(g, [0, 1], planner=cache)
    msbfs(g, [2, 3, 4], planner=cache)        # same padded width: a hit
    assert cache.stats() == {"hits": 1, "misses": 1, "evictions": 0,
                             "size": 1, "capacity": 2}
    mskhop(g, [0], 2, planner=cache)
    batched_ppr(g, [0], planner=cache)        # third plan evicts msbfs
    assert (cache.hits, cache.misses, cache.evictions) == (1, 3, 1)
    assert len(cache) == 2
    msbfs(g, list(range(33)), planner=cache)  # 64 wide: a new plan
    assert cache.misses == 4
    key = plan_key(g, "ppr", 32)
    assert key in cache and cache.keys()[0] == key
    cache.clear()
    assert cache.stats()["size"] == 0 and cache.hits == 0
    with pytest.raises(ValueError):
        PlanCache(capacity=0)


def test_plan_key_tells_layout_and_backend_apart():
    g = port_graph(8, "b2sr")
    keys = {plan_key(g, "msbfs", 32),
            plan_key(g.with_buckets(False), "msbfs", 32),
            plan_key(g.with_backend("b2sr_cuda"), "msbfs", 32),
            plan_key(g.with_backend("csr"), "msbfs", 32),
            plan_key(port_graph(4, "b2sr"), "msbfs", 32),
            plan_key(g, "msbfs", 64), plan_key(g, "ppr", 32)}
    assert len(keys) == 7
    assert plan_key(g, "msbfs", 32).bucket_layout is not None
    assert plan_key(g.with_buckets(False), "msbfs", 32).bucket_layout is None
    # structure, not the wrapper: a rebuilt graph shares the fingerprint
    r, c = coo()
    twin = GraphMatrix.from_coo(r, c, N, N, 8, device="cpu")
    assert twin.fingerprint() == g.fingerprint()
    assert plan_key(twin, "msbfs", 32) == plan_key(g, "msbfs", 32)
    other = GraphMatrix.from_coo(r[1:], c[1:], N, N, 8, device="cpu")
    assert other.fingerprint() != g.fingerprint()
    assert g.fingerprint_cache == g.fingerprint()        # memoized


# -- the batcher ----------------------------------------------------------------------------

def test_batcher_coalesces_dedups_and_scatters():
    g = port_graph(8, "b2sr_cuda")
    cache = PlanCache()
    b = QueryBatcher(planner=cache)
    bfs_src = [3, 9, 3, 40, 9, 3]
    hb = [b.bfs(g, s) for s in bfs_src]
    hp = [b.ppr(g, s) for s in (1, 2, 1)]
    hk = b.khop(g, 7, k=2)
    hs = b.sssp(g, 7, edge_weight=0.5)
    assert b.pending() == 11 and not hb[0].done()
    b.flush()
    assert b.pending() == 0 and b.n_launches == 4
    assert b.n_deduped == 3 + 1                  # 6 -> 3 bfs, 3 -> 2 ppr
    want = msbfs(g, [3, 9, 40]).levels
    for s, h in zip(bfs_src, hb):
        assert torch.equal(h.result(), want[:, [3, 9, 40].index(s)])
    ranks = batched_ppr(g, [1, 2]).ranks
    assert torch.equal(hp[0].result(), ranks[:, 0])
    assert torch.equal(hp[2].result(), ranks[:, 0])
    assert torch.equal(hk.result(), khop_frontier(g, 7, 2))
    assert torch.equal(hs.result(), sssp(g, 7, 0.5).distances)


def test_batcher_pads_to_powers_of_two():
    g = port_graph(8, "b2sr")
    assert [batcher_mod._next_pow2(n) for n in (1, 2, 3, 5, 33)] == [
        1, 2, 4, 8, 64]
    cache = PlanCache()
    b = QueryBatcher(planner=cache)
    qs = [batcher_mod._Pending(g, "bfs", s, (), None) for s in (4, 8, 15)]
    for q in qs:
        q.handle = batcher_mod.QueryHandle(None)
    n_dedup, padded = batcher_mod.launch_group(g, "bfs", {}, qs, cache)
    assert n_dedup == 0 and padded == (4, 8, 15, 4)
    for s in (1, 2, 3, 5, 6):                # 5 queries -> 8 columns
        b.bfs(g, s)
    b.flush()
    assert cache.misses == 1 and cache.hits == 1     # both fit 32 wide


def test_batcher_validates_at_submit():
    g = port_graph(8, "b2sr")
    b = QueryBatcher()
    with pytest.raises(ValueError, match=f"{N} nodes"):
        b.bfs(g, N)
    with pytest.raises(ValueError, match="unknown query kind"):
        b.submit(g, "tc", 0)
    with pytest.raises(ValueError, match=f"{N} nodes"):
        b.gnn_infer(g, N, model="gcn")
    assert b.pending() == 0


def test_batcher_isolates_a_failing_group():
    g = port_graph(8, "b2sr")
    b = QueryBatcher()
    good = b.bfs(g, 3)
    bad = b.khop(g, 4, k=0)                  # mskhop raises for k < 1
    bad2 = b.ppr(g, 4, max_iters="x")        # fails inside the loop
    with pytest.raises(BatchFlushError) as info:
        b.flush()
    assert [e.kind for e in info.value.errors] == ["khop", "ppr"]
    assert torch.equal(good.result(), bfs(g, 3).levels)
    with pytest.raises(QueryGroupError, match="khop") as e1:
        bad.result()
    with pytest.raises(QueryGroupError) as e2:
        bad.result()
    assert e1.value is e2.value and isinstance(e1.value.__cause__,
                                               ValueError)
    with pytest.raises(QueryGroupError, match="ppr"):
        bad2.result()


# -- on the card ------------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_engine_on_card_launches_the_kernels(cuda):
    r, c = PG.rmat_graph(2000, avg_degree=12, seed=5)
    g = GraphMatrix.from_coo(r, c, 2000, 2000, 32, backend="b2sr_cuda",
                             device=cuda)
    gc = g.with_backend("csr")
    srcs = list(range(0, 2000, 29))
    before = (spmm.spmm_bbb.launches, spmm.spmm_dense.launches)
    for d in ("push", "pull", "auto"):
        a, b = msbfs(g, srcs, direction=d), msbfs(gc, srcs, direction=d)
        assert torch.equal(a.levels, b.levels)
        assert (a.n_iterations, a.directions) == (b.n_iterations,
                                                  b.directions)
    assert torch.equal(mskhop(g, srcs, 2), mskhop(gc, srcs, 2))
    pa, pb = batched_ppr(g, srcs[:32]), batched_ppr(gc, srcs[:32])
    assert torch.allclose(pa.ranks, pb.ranks, rtol=1e-4, atol=1e-7)
    assert spmm.spmm_bbb.launches > before[0]
    assert spmm.spmm_dense.launches == before[1] + pa.n_iterations
