"""PyTorch port vs the JAX reference: SSSP, PageRank/PPR and CC.

The same seeded graph goes through ``repro`` (``b2sr``) and
``repro_torch`` (``b2sr``, ``b2sr_cuda`` and ``csr``, buckets on and off,
on the CPU; ``b2sr_cuda`` on a CPU graph runs the kernels' plain
versions). SSSP distances, CC labels, CC direction traces and every
``n_iterations`` must be equal. Ranks are allclose with ``rtol=1e-5,
atol=1e-7``: every backend sums each row's float32 terms in its own
order (the reference itself sums in two), and ten power iterations carry
those few-ulp differences along. The test marked ``cuda`` runs the
kernels on the card and skips here.
"""

from __future__ import annotations

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

try:
    import jax.numpy as jnp
    from repro import algorithms as RA
    from repro.core import b2sr as R
    from repro.core.graphblas import GraphMatrix as RGraph
except ImportError:                      # a card's machine without JAX
    jnp = None

from repro_torch import convert  # noqa: E402
from repro_torch.algorithms import (connected_components, pagerank,  # noqa: E402
                                    ppr, sssp)
from repro_torch.core.graphblas import GraphMatrix  # noqa: E402
from repro_torch.core.words import to_numpy_u32  # noqa: E402
from repro_torch.data import graphs as PG  # noqa: E402
from repro_torch.kernels.bmv import bmv  # noqa: E402

needs_reference = pytest.mark.skipif(
    jnp is None, reason="the JAX reference package needs jax")

N = 200                                   # not a multiple of 16 or 32
SOURCES = (3, 150)
DIRECTIONS = ("push", "pull", "auto")
RTOL, ATOL = 1e-5, 1e-7
BACKEND_CASES = (("b2sr", False), ("b2sr", True), ("b2sr_cuda", False),
                 ("b2sr_cuda", True), ("csr", False))


@functools.lru_cache(maxsize=None)
def graph_coo():
    """rmat skew plus an Erdős scatter plus isolated vertices: CC sees
    several components and auto switches between A and Aᵀ."""
    r1, c1 = PG.rmat_graph(N - 20, avg_degree=6, seed=1)
    r2, c2 = PG.dot_graph(N - 20, density=0.01, seed=2)
    return PG._dedup_sym(np.concatenate([r1, r2]), np.concatenate([c1, c2]),
                         N)


@functools.lru_cache(maxsize=None)
def ref_graph(t):
    r, c = graph_coo()
    return RGraph.from_coo(r, c, N, N, t)


@functools.lru_cache(maxsize=None)
def port_graph(t):
    r, c = graph_coo()
    return GraphMatrix.from_coo(r, c, N, N, t, device="cpu")


def graph(t, backend, buckets):
    return port_graph(t).with_backend(backend).with_buckets(buckets)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    return torch.device("cuda")


# -- SSSP ----------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def ref_sssp(t, source, edge_weight):
    res = RA.sssp(ref_graph(t), source, edge_weight=edge_weight)
    return np.asarray(res.distances), res.n_iterations


def assert_same_sssp(want, res):
    dist, n_it = want
    assert res.distances.dtype == torch.float32
    assert np.array_equal(res.distances.numpy(), dist)
    assert res.n_iterations == n_it


@needs_reference
@pytest.mark.parametrize("edge_weight", (1.0, 0.5))
@pytest.mark.parametrize("source", SOURCES)
@pytest.mark.parametrize("backend,buckets", BACKEND_CASES)
@pytest.mark.parametrize("t", (8, 32))
def test_sssp_matches_reference(t, backend, buckets, source, edge_weight):
    res = sssp(graph(t, backend, buckets), source, edge_weight=edge_weight)
    assert_same_sssp(ref_sssp(t, source, edge_weight), res)


@needs_reference
def test_sssp_reaches_only_the_source_component():
    dist = ref_sssp(8, SOURCES[0], 1.0)[0]
    assert np.isinf(dist).any() and (dist == 0).sum() == 1


@needs_reference
@pytest.mark.parametrize("backend", ("b2sr", "b2sr_cuda", "csr"))
def test_from_reference_graph_sssp_matches(backend):
    """The reference's B2SR arrays carried across give the same SSSP."""
    r, c = graph_coo()
    m = R.coo_to_b2sr(r, c, N, N, 8)
    arrays = {}
    for p, mat in (("", m), ("t.", R.transpose(m))):
        for f in ("tile_row_ptr", "tile_col_idx", "bit_tiles"):
            arrays[p + f] = np.asarray(getattr(mat, f))
    meta = {"tile_dim": 8, "n_rows": N, "n_cols": N, "nnz": m.nnz}
    g = convert.from_reference(arrays, meta, device="cpu", backend=backend)
    assert np.array_equal(to_numpy_u32(g.b2sr.bit_tiles),
                          np.asarray(m.bit_tiles))
    assert_same_sssp(ref_sssp(8, SOURCES[1], 0.5),
                     sssp(g, SOURCES[1], edge_weight=0.5))


def test_sssp_rejects_what_the_slice_does_not_run():
    g = port_graph(8)
    with pytest.raises(ValueError, match="row_chunk"):
        sssp(g, [0, 1], row_chunk=2)
    with pytest.raises(ValueError, match="out of range"):
        sssp(g, [0, N])
    for bad in (N, -1):
        with pytest.raises(ValueError):
            sssp(g, bad)


def test_sssp_max_iters_stops_early():
    g = port_graph(8)
    assert sssp(g, SOURCES[0], max_iters=0).n_iterations == 0
    res = sssp(g, SOURCES[0], max_iters=2)
    assert res.n_iterations == 2
    assert float(res.distances[torch.isfinite(res.distances)].max()) == 2.0


# -- PageRank / PPR ------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def ref_rank(t, kind):
    rg = ref_graph(t)
    if kind == "pagerank":
        res = RA.pagerank(rg)
    elif kind == "ppr_node":
        res = RA.ppr(rg, SOURCES[0])
    else:
        res = RA.ppr(rg, jnp.asarray(restart_vector()))
    return np.asarray(res.ranks), res.n_iterations


def restart_vector():
    v = np.random.default_rng(11).random(N).astype(np.float32)
    return v / v.sum()


@needs_reference
@pytest.mark.parametrize("kind", ("pagerank", "ppr_node", "ppr_vector"))
@pytest.mark.parametrize("backend,buckets", BACKEND_CASES)
@pytest.mark.parametrize("t", (8, 32))
def test_ranks_match_reference(t, backend, buckets, kind):
    g = graph(t, backend, buckets)
    if kind == "pagerank":
        res = pagerank(g)
    elif kind == "ppr_node":
        res = ppr(g, SOURCES[0])
    else:
        res = ppr(g, restart_vector())
    ranks, n_it = ref_rank(t, kind)
    assert res.ranks.dtype == torch.float32 and res.ranks.shape == (N,)
    np.testing.assert_allclose(res.ranks.numpy(), ranks, rtol=RTOL,
                               atol=ATOL)
    assert res.n_iterations == n_it


def test_pagerank_stops_on_eps():
    g = port_graph(8)
    res = pagerank(g, max_iters=100, eps=1e-4)
    assert 1 < res.n_iterations < 100
    assert res.n_iterations == pagerank(g, max_iters=100, eps=1e-4
                                        ).n_iterations


def test_ppr_rejects_bad_seeds():
    g = port_graph(8)
    for bad in (N, -1):
        with pytest.raises(ValueError, match="out of range"):
            ppr(g, bad)
    with pytest.raises(ValueError, match="shape"):
        ppr(g, np.ones(N + 1, np.float32))


# -- CC ------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def ref_cc(t, mode):
    res = RA.connected_components(ref_graph(t), direction=mode)
    return np.asarray(res.labels), res.n_iterations, res.directions


def assert_same_cc(want, res):
    labels, n_it, dirs = want
    assert res.labels.dtype == torch.int32
    assert np.array_equal(res.labels.numpy(), labels)
    assert (res.n_iterations, res.directions) == (n_it, dirs)


@needs_reference
@pytest.mark.parametrize("mode", DIRECTIONS)
@pytest.mark.parametrize("backend,buckets", BACKEND_CASES)
@pytest.mark.parametrize("t", (8, 32))
def test_cc_matches_reference(t, backend, buckets, mode):
    res = connected_components(graph(t, backend, buckets), direction=mode)
    assert_same_cc(ref_cc(t, mode), res)


@needs_reference
def test_cc_sees_components_and_switches():
    labels, _, dirs = ref_cc(8, "auto")
    assert len(np.unique(labels)) > 1
    assert "pull" in dirs and "push" in dirs


@needs_reference
@pytest.mark.parametrize("backend", ("b2sr", "b2sr_cuda"))
def test_cc_without_transpose_runs_push(backend):
    r, c = graph_coo()
    g = GraphMatrix.from_coo(r, c, N, N, 8, with_transpose=False,
                             backend=backend, device="cpu")
    res = connected_components(g, direction="auto")
    assert set(res.directions) == {"push"}
    assert np.array_equal(res.labels.numpy(), ref_cc(8, "auto")[0])


# -- on the card ----------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("t", (8, 32))
def test_algorithms_on_card_match_plain(cuda, t):
    """b2sr_cuda on the card against the same entry points on the CPU
    (the plain versions): SSSP and CC exact, ranks allclose."""
    r, c = graph_coo()
    g = GraphMatrix.from_coo(r, c, N, N, t, device=cuda, backend="b2sr_cuda")
    plain = port_graph(t).with_backend("b2sr_cuda")
    before = bmv.bmv_bff.launches
    for s in SOURCES:
        got, want = sssp(g, s, edge_weight=0.5), sssp(plain, s,
                                                      edge_weight=0.5)
        assert torch.equal(got.distances.cpu(), want.distances)
        assert got.n_iterations == want.n_iterations
    for mode in DIRECTIONS:
        got = connected_components(g, direction=mode)
        want = connected_components(plain, direction=mode)
        assert torch.equal(got.labels.cpu(), want.labels)
        assert (got.n_iterations, got.directions) == (want.n_iterations,
                                                      want.directions)
    for got, want in ((pagerank(g), pagerank(plain)),
                      (ppr(g, SOURCES[0]), ppr(plain, SOURCES[0]))):
        np.testing.assert_allclose(got.ranks.cpu().numpy(),
                                   want.ranks.numpy(), rtol=RTOL, atol=ATOL)
    assert bmv.bmv_bff.launches > before
