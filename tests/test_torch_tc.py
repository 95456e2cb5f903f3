"""PyTorch port vs the JAX reference: triangle counting and k-hop.

The same seeded COO goes through ``repro`` and ``repro_torch`` (on the
CPU; ``b2sr_cuda`` on a CPU graph runs the kernels' plain versions),
each port backend against its reference twin (``b2sr_cuda`` against
``b2sr_pallas`` in interpret mode). Every result is an integer or a bit
pattern and must be equal: the triangle count (the reference's float32
holds these small counts exactly; the port's is int64), the k-hop reach
matrix's B2SR arrays and ``n_iterations``, the k-hop frontier. The tests
marked ``cuda`` hold the TC kernel against its plain version on the card
and skip here.
"""

from __future__ import annotations

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

try:
    import jax.numpy as jnp
    from repro import algorithms as RA
    from repro.core.graphblas import GraphMatrix as RGraph
except ImportError:                      # a card's machine without JAX
    jnp = None

from repro_torch.algorithms import (khop_frontier, khop_reachability,  # noqa: E402
                                    triangle_count)
from repro_torch.core import b2sr as P  # noqa: E402
from repro_torch.core import csr as csr_mod  # noqa: E402
from repro_torch.core.graphblas import GraphMatrix  # noqa: E402
from repro_torch.core.words import to_numpy_u32  # noqa: E402
from repro_torch.data import graphs as PG  # noqa: E402
from repro_torch.kernels.bmm import bmm, ref  # noqa: E402

needs_reference = pytest.mark.skipif(
    jnp is None, reason="the JAX reference package needs jax")

N = 60                                    # not a multiple of 8, 16 or 32
TILE_DIMS = (4, 8, 16, 32)
#: (port backend, buckets, reference backend)
BACKEND_CASES = (("b2sr", False, "b2sr"), ("b2sr", True, "b2sr"),
                 ("b2sr_cuda", False, "b2sr_pallas"), ("csr", False, "csr"))


@functools.lru_cache(maxsize=None)
def coo(name: str = "rmat"):
    if name == "rmat":
        return PG.rmat_graph(N, avg_degree=8, seed=5)
    if name == "road":
        return PG.road_graph(7)
    if name == "path":                   # 0 - 1 - ... - 5: diameter 5
        r = np.arange(5)
        return PG._dedup_sym(r, r + 1, 6)
    return PG.dot_graph(N, density=0.15, seed=6)


def size(name: str) -> int:
    return {"road": 49, "path": 6}.get(name, N)


@functools.lru_cache(maxsize=None)
def ref_graph(name: str, t: int, backend: str, buckets: bool = True):
    r, c = coo(name)
    n = size(name)
    return RGraph.from_coo(r, c, n, n, t).with_backend(backend).with_buckets(
        buckets)


@functools.lru_cache(maxsize=None)
def port_graph(name: str, t: int, backend: str, buckets: bool = True):
    r, c = coo(name)
    n = size(name)
    return GraphMatrix.from_coo(r, c, n, n, t, device="cpu",
                                backend=backend).with_buckets(buckets)


def triangles(name: str) -> int:
    """Triangles of the undirected graph, by dense numpy (the truth)."""
    r, c = coo(name)
    n = size(name)
    a = np.zeros((n, n), np.int64)
    a[r, c] = 1
    return int(np.trace(a @ a @ a)) // 6


# -- triangle counting ----------------------------------------------------------

@needs_reference
@pytest.mark.parametrize("backend,buckets,ref_backend", BACKEND_CASES)
@pytest.mark.parametrize("t", TILE_DIMS)
def test_tri_count_matches_reference(t, backend, buckets, ref_backend):
    g = port_graph("rmat", t, backend, buckets)
    got = g.tri_count()
    assert got.dtype == torch.int64 and got.dim() == 0
    want = RA.triangle_count(ref_graph("rmat", t, ref_backend, buckets))
    assert int(got) == want == triangles("rmat")
    assert triangle_count(g) == want


@pytest.mark.parametrize("backend,buckets", [c[:2] for c in BACKEND_CASES])
@pytest.mark.parametrize("name", ("k4", "road", "dot"))
def test_triangle_count_is_exact(name, backend, buckets, monkeypatch):
    monkeypatch.setattr(csr_mod, "CHUNK_WEDGES", 64)     # several chunks
    if name == "k4":
        r, c = np.nonzero(1 - np.eye(4, dtype=np.int64))
        g = GraphMatrix.from_coo(r, c, 4, 4, 8, device="cpu",
                                 backend=backend).with_buckets(buckets)
        assert triangle_count(g) == 4
        return
    g = port_graph(name, 8, backend, buckets)
    assert triangle_count(g) == triangles(name)
    assert triangle_count(g, row_chunk=4 if backend != "b2sr" else None) \
        == triangles(name)


def test_lower_triangle_is_memoized_and_sorted():
    g = port_graph("rmat", 8, "b2sr_cuda")
    g.tri_count()
    tri = g.tri_cache
    assert tri._b2sr is not None              # built at once for the kernel
    g.tri_count()
    assert g.tri_cache is tri
    assert g.with_backend("csr").tri_cache is tri
    assert g.transposed().tri_cache is None
    assert bool((tri.rows > tri.cols).all())
    lower = tri.b2sr
    same_row = P.tile_rows(lower)[1:] == P.tile_rows(lower)[:-1]
    step = lower.tile_col_idx[1:] - lower.tile_col_idx[:-1]
    assert bool((step[same_row] > 0).all())
    fresh = port_graph("rmat", 8, "csr")
    fresh.tri_count()
    assert fresh.tri_cache._b2sr is None      # csr never packs L


# -- the plain TC reduction against the reference's Pallas kernel ---------------

@needs_reference
@pytest.mark.parametrize("t", (8, 32))
@pytest.mark.parametrize("case", ("tri", "general"))
def test_plain_bmm_matches_pallas(case, t):
    from repro.core import b2sr as R
    from repro.kernels.bmm import ops as r_kops
    if case == "tri":
        r, c = coo("rmat")
        keep = r > c
        mats = [(r[keep], c[keep], N, N)] * 3            # A = mask = L
        bt = mats[0]                                      # Bᵀ = L
    else:
        rng = np.random.default_rng(t)
        dense = [rng.random(s) < 0.2 for s in ((30, 45), (45, 38), (30, 38))]
        mats = [(*np.nonzero(d), *d.shape) for d in dense]
        bt = (*np.nonzero(dense[1].T), 38, 45)
    (ra, ca, na, ka), (rb, cb, kb, nb), (rm, cm, nm, km) = mats
    r_b = R.to_ell(R.coo_to_b2sr(rb, cb, kb, nb, t))
    want = r_kops.bmm_bin_bin_sum_masked(
        R.to_ell(R.coo_to_b2sr(ra, ca, na, ka, t)),
        r_b if case == "general" else R.to_ell(R.transpose(
            R.coo_to_b2sr(rb, cb, kb, nb, t))),
        R.to_ell(R.coo_to_b2sr(rm, cm, nm, km, t)), interpret=True)
    got = ref.bmm_tc(P.coo_to_b2sr(ra, ca, na, ka, t, "cpu"),
                     P.coo_to_b2sr(*bt, t, "cpu"),
                     P.coo_to_b2sr(rm, cm, nm, km, t, "cpu"))
    assert got.dtype == torch.int64 and int(got) == int(want)
    dense = [np.zeros(m[2:], np.int64) for m in mats]
    for d, m in zip(dense, mats):
        d[m[0], m[1]] = 1
    b_dense = dense[0].T if case == "tri" else dense[1]
    assert int(got) == int(((dense[0] @ b_dense) * dense[2]).sum())


@needs_reference
@pytest.mark.parametrize("row_chunk", (None, 2))
def test_bmm_schemes_match_reference(row_chunk):
    """The word schemes ``bmm_bin_bin_sum(_masked)`` (no registry row uses
    them, in either package) on L, Lᵀ: int64 here, float32 there."""
    from repro.core import b2sr as R
    from repro.core import ops as r_ops
    from repro_torch.core import ops as p_ops
    t = 8
    r, c = coo("rmat")
    keep = r > c
    lr = R.coo_to_b2sr(r[keep], c[keep], N, N, t)
    lp = P.coo_to_b2sr(r[keep], c[keep], N, N, t, "cpu")
    r_ell, r_ell_t = R.to_ell(lr), R.to_ell(R.transpose(lr))
    p_ell, p_ell_t = P.to_ell(lp), P.to_ell(P.transpose(lp))
    got = p_ops.bmm_bin_bin_sum_masked(p_ell, p_ell_t, p_ell, row_chunk)
    assert got.dtype == torch.int64
    assert int(got) == int(r_ops.bmm_bin_bin_sum_masked(
        r_ell, r_ell_t, r_ell, row_chunk)) == triangles("rmat")
    got = p_ops.bmm_bin_bin_sum(p_ell, p_ell_t, row_chunk)
    assert int(got) == int(r_ops.bmm_bin_bin_sum(r_ell, r_ell_t, row_chunk))


def test_bmm_wrapper_checks_its_inputs():
    lower = port_graph("rmat", 8, "b2sr_cuda").b2sr
    other = P.coo_to_b2sr([0], [1], N + 8, N, 8, "cpu")
    with pytest.raises(ValueError, match="mask is"):
        bmm.bmm_tc(lower, lower, other)
    with pytest.raises(ValueError, match="inner-dim"):
        bmm.bmm_tc(lower, P.coo_to_b2sr([0], [1], N, N + 8, 8, "cpu"),
                   lower)
    with pytest.raises(ValueError, match="kernel"):
        bmm.bmm_tc(lower, lower, lower, with_work=True)
    before = bmm.bmm_tc.launches
    bmm.bmm_tc(lower, lower, lower)          # CPU: the plain version
    assert bmm.bmm_tc.launches == before


# -- k-hop ------------------------------------------------------------------------

def reach_arrays(g):
    ell = g.ell
    col = np.asarray(ell.tile_col_idx)
    valid = col >= 0
    ptr = np.concatenate([[0], np.cumsum(np.asarray(ell.row_n_tiles))])
    return ptr.astype(np.int32), col[valid], np.asarray(ell.bit_tiles)[valid]


@needs_reference
@pytest.mark.parametrize("k", (1, 2, 4))
@pytest.mark.parametrize("backend,buckets,ref_backend",
                         [c for c in BACKEND_CASES if c[1] is False])
@pytest.mark.parametrize("name", ("dot", "path"))
def test_khop_reachability_matches_reference(name, backend, buckets,
                                             ref_backend, k):
    t = 8
    want = RA.khop_reachability(ref_graph(name, t, ref_backend), k)
    got = khop_reachability(port_graph(name, t, backend), k)
    assert got.n_iterations == want.n_iterations
    m = got.reach.b2sr
    for w, p in zip(reach_arrays(want.reach),
                    (m.tile_row_ptr.numpy(), m.tile_col_idx.numpy(),
                     to_numpy_u32(m.bit_tiles))):
        assert np.array_equal(w, p)
    assert got.reach.nnz == want.reach.nnz
    assert got.reach.backend == backend and got.reach.bwd is not None


@pytest.mark.parametrize("backend", ("b2sr", "b2sr_cuda", "csr"))
def test_khop_exits_early_on_a_path(backend):
    res = khop_reachability(port_graph("path", 4, backend), 10)
    assert res.n_iterations == 5                 # the diameter
    assert res.reach.nnz == 6 * 6                # every pair, i -> i in 2
    # walks of 1 to 3 steps: distances 1, 2 and 3, and i -> i
    assert khop_reachability(port_graph("path", 4, backend), 3).reach.nnz \
        == 2 * (5 + 4 + 3) + 6


@needs_reference
@pytest.mark.parametrize("backend,buckets,ref_backend", BACKEND_CASES)
def test_khop_frontier_matches_reference(backend, buckets, ref_backend):
    for source, k in ((0, 2), (17, 3)):
        want = RA.khop_frontier(ref_graph("road", 8, ref_backend, buckets),
                                source, k)
        got = khop_frontier(port_graph("road", 8, backend, buckets), source,
                            k)
        assert got.dtype == torch.bool
        assert np.array_equal(np.asarray(want), got.numpy())


def test_khop_rejects_what_the_reference_rejects():
    g = port_graph("dot", 8, "b2sr")
    with pytest.raises(ValueError, match="k must"):
        khop_reachability(g, 0)
    rect = GraphMatrix.from_coo([0], [1], 8, 9, 8, device="cpu")
    with pytest.raises(ValueError, match="square"):
        khop_reachability(rect, 2)
    no_t = GraphMatrix.from_coo(*coo("dot"), N, N, 8, device="cpu",
                                with_transpose=False)
    with pytest.raises(ValueError, match="transpose"):
        khop_frontier(no_t, 0, 2)
    with pytest.raises(ValueError, match="outside"):
        khop_frontier(g, N, 2)


# -- on the card ----------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("t", TILE_DIMS)
def test_bmm_kernel_matches_plain_on_card(cuda, t):
    r, c = coo("rmat")
    g = GraphMatrix.from_coo(r, c, N, N, t, device=cuda, backend="b2sr_cuda")
    before = bmm.bmm_tc.launches
    got = g.tri_count()
    plan = g.tri_cache.cache["bmm_tc_plan"]   # one launch per part it fills
    assert bmm.bmm_tc.launches == before + sum(
        p is not None and p.n_tiles > 0 for p in (plan.kept, plan.moved))
    assert int(got) == triangles("rmat")
    lower = g.tri_cache.b2sr
    total, work = bmm.bmm_tc(lower, lower, lower, with_work=True)
    assert int(total) == int(ref.bmm_tc(lower, lower, lower)) and work > 0
    res = khop_reachability(g, 3)
    want = khop_reachability(g.with_backend("csr"), 3)
    assert res.n_iterations == want.n_iterations
    assert torch.equal(res.reach.b2sr.bit_tiles, want.reach.b2sr.bit_tiles)
