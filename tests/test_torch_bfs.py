"""PyTorch port vs the JAX reference: the mxv rows and direction-optimizing BFS.

The same seeded graph goes through ``repro`` and ``repro_torch`` (both on
the CPU); ``levels``, ``n_iterations`` and the direction trace must be
equal for push/pull/auto × backends ``b2sr``/``b2sr_cuda``/``csr`` ×
buckets on/off (tolerance: exact, every output is boolean or integer).
``b2sr_cuda`` on a CPU graph runs the kernels' plain versions; the test
marked ``cuda`` runs the kernels, needs no JAX, and skips here.
"""

from __future__ import annotations

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

try:
    import jax.numpy as jnp
    from repro.algorithms import direction as r_direction
    from repro.algorithms.bfs import bfs as r_bfs
    from repro.core.descriptor import Descriptor as RDescriptor
    from repro.core.graphblas import GraphMatrix as RGraph
    from repro.core.operands import BitVector as RBitVector
except ImportError:                      # a card's machine without JAX
    jnp = None

from repro_torch import convert  # noqa: E402
from repro_torch.algorithms import direction  # noqa: E402
from repro_torch.algorithms.bfs import bfs  # noqa: E402
from repro_torch.core.descriptor import Descriptor  # noqa: E402
from repro_torch.core.graphblas import GraphMatrix  # noqa: E402
from repro_torch.core.operands import BitVector  # noqa: E402
from repro_torch.core.semiring import BOOLEAN  # noqa: E402
from repro_torch.core.words import from_numpy_u32, to_numpy_u32  # noqa: E402
from repro_torch.data import graphs as PG  # noqa: E402
from repro_torch.kernels.bmv import bmv  # noqa: E402

needs_reference = pytest.mark.skipif(
    jnp is None, reason="the JAX reference package needs jax")

N = 200                                   # not a multiple of 16 or 32
SOURCE = 3
DIRECTIONS = ("push", "pull", "auto")
#: (backend, use_buckets) — csr has no bucketed path (registered for both)
BACKEND_CASES = (("b2sr", False), ("b2sr", True), ("b2sr_cuda", False),
                 ("b2sr_cuda", True), ("csr", False))


@functools.lru_cache(maxsize=None)
def graph_coo():
    """rmat skew plus an Erdős scatter: auto switches to pull and back."""
    r1, c1 = PG.rmat_graph(N, avg_degree=6, seed=1)
    r2, c2 = PG.dot_graph(N, density=0.01, seed=2)
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


@functools.lru_cache(maxsize=None)
def ref_bfs(t, mode, max_iters=None, row_chunk=None):
    res = r_bfs(ref_graph(t), SOURCE, max_iters=max_iters,
                row_chunk=row_chunk, direction=mode)
    return np.asarray(res.levels), res.n_iterations, res.directions


def assert_same_bfs(want, res):
    levels, n_it, dirs = want
    assert np.array_equal(levels, res.levels.numpy())
    assert res.levels.dtype == torch.int32
    assert (n_it, dirs) == (res.n_iterations, res.directions)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    return torch.device("cuda")


# -- the mxv rows through the generic API -----------------------------------

MXV_CASES = ("plain", "mask", "mask_keep", "no_replace", "pull", "vxm")


@needs_reference
@pytest.mark.parametrize("case", MXV_CASES)
@pytest.mark.parametrize("backend,buckets", BACKEND_CASES)
def test_mxv_rows_match_reference(backend, buckets, case):
    t = 8
    rng = np.random.default_rng(len(case))
    xv = (rng.random(N) < 0.15).astype(np.float32)
    mv = (rng.random(N) < 0.5).astype(np.float32)
    ov = (rng.random(N) < 0.5).astype(np.float32)
    rg = ref_graph(t)
    pg = port_graph(t).with_backend(backend).with_buckets(buckets)
    rx, rm, ro = (RBitVector.pack(jnp.asarray(v), t, N) for v in (xv, mv, ov))
    px, pm, po = (BitVector.pack(torch.from_numpy(v), t, N)
                  for v in (xv, mv, ov))

    def desc(mod, mask, **kw):
        if case == "plain":
            return mod(**kw)
        comp = case != "mask_keep"
        return mod(mask=mask, complement=comp,
                   replace=case != "no_replace",
                   direction="pull" if case == "pull" else None, **kw)

    if case == "vxm":
        want = rg.vxm(rx, desc=RDescriptor(mask=rm, complement=True))
        got = pg.vxm(px, desc=Descriptor(mask=pm, complement=True))
    else:
        want = rg.mxv(rx, desc=desc(RDescriptor, rm), out=ro)
        got = pg.mxv(px, desc=desc(Descriptor, pm), out=po)
    assert isinstance(got, BitVector) and got.n == N
    assert np.array_equal(np.asarray(want.words), to_numpy_u32(got.words))


@needs_reference
def test_registry_covers_reference_packed_rows():
    from repro.core import dispatch as r_dispatch
    from repro_torch.core import dispatch as p_dispatch
    backend = {"b2sr": "b2sr", "b2sr_pallas": "b2sr_cuda", "csr": "csr"}
    got = set(p_dispatch.registered_keys(load_all=True))
    # every (op, operand) column of the reference is ported
    ported = {("mxv", "dense"), ("mxv", "bitvec"), ("mxv_pull", "bitvec"),
              ("mxm", "graph"), ("mxm_sum", "tri"), ("mxm", "dense"),
              ("mxm", "frontier"), ("mxm_pull", "frontier"),
              ("mxm", "bitmat")}
    assert {k[:2] for k in got} == ported
    # the sharded rows (k[6]) too: the b2sr backends register the
    # reference's sharded keys, csr none
    want = {k[:3] + (backend[k[3]],) + k[4:]
            for k in r_dispatch.registered_keys(load_all=True)
            if k[:2] in ported}
    assert want == got
    for key in want:
        assert p_dispatch.resolve(*key) is not None
    for op in p_dispatch.OPS:
        flags = {k[5] for k in got if k[0] == op}
        assert flags == ({True} if op in p_dispatch.MASKED_ONLY_OPS
                         else {False, True})


@needs_reference
def test_graph_helpers_match_reference():
    from repro.core.dispatch import apply_output_mask as r_mask
    from repro_torch.core.dispatch import apply_output_mask
    r, c = graph_coo()
    dense = np.zeros((N, N), np.float32)
    dense[r, c] = 1
    g = GraphMatrix.from_dense(dense, 8, device="cpu")
    assert torch.equal(g.b2sr.bit_tiles, port_graph(8).b2sr.bit_tiles)
    assert np.array_equal(np.asarray(ref_graph(8).degrees()),
                          g.degrees().numpy())
    y = np.arange(N, dtype=np.float32)
    m = (np.arange(N) % 3 == 0)
    for comp in (True, False):
        want = r_mask(jnp.asarray(y), jnp.asarray(m), comp, jnp.float32(-1))
        got = apply_output_mask(torch.from_numpy(y), torch.from_numpy(m),
                                comp, torch.tensor(-1.0))
        assert np.array_equal(np.asarray(want), got.numpy())


@needs_reference
@pytest.mark.parametrize("name", ("boolean", "arithmetic", "min_plus",
                                  "max_times"))
def test_csr_mxv_semirings_match_reference(name):
    from repro.core import csr as r_csr
    from repro.core.semiring import SEMIRINGS as R_SEMIRINGS
    from repro_torch.core import csr as p_csr
    from repro_torch.core.semiring import SEMIRINGS
    r, c = graph_coo()
    x = np.random.default_rng(0).random(N).astype(np.float32)
    want = r_csr.mxv(r_csr.from_coo(r, c, N, N), jnp.asarray(x),
                     R_SEMIRINGS[name])
    got = p_csr.mxv(p_csr.from_coo(r, c, N, N, device="cpu"),
                    torch.from_numpy(x), SEMIRINGS[name])
    assert np.array_equal(np.asarray(want), got.numpy())


@needs_reference
def test_bitvector_algebra_matches_reference():
    rng = np.random.default_rng(5)
    a, b = ((rng.random(N) < 0.4).astype(np.float32) for _ in range(2))
    ra, rb = (RBitVector.pack(jnp.asarray(v), 8, N) for v in (a, b))
    pa, pb = (BitVector.pack(torch.from_numpy(v), 8, N) for v in (a, b))
    for want, got in ((ra | rb, pa | pb), (ra & rb, pa & pb), (~ra, ~pa)):
        assert np.array_equal(np.asarray(want.words), to_numpy_u32(got.words))
    assert bool(pa.any()) and not bool((pa & ~pa).any())
    assert np.array_equal(np.asarray(ra.unpack()), pa.unpack().numpy())


def test_pending_rows_name_the_roadmap():
    """Every mxv row is ported; what the reference lacks still raises."""
    g = port_graph(8).with_backend("b2sr_cuda")
    with pytest.raises(NotImplementedError, match="boolean"):
        g.mxv(torch.ones(N) > 0, BOOLEAN)
    with pytest.raises(ValueError, match="pull"):
        g.mxv(BitVector.pack(torch.ones(N), 8, N),
              desc=Descriptor(direction="pull"))


# -- the direction policy -----------------------------------------------------

@needs_reference
def test_next_direction_matches_reference():
    rng = np.random.default_rng(0)
    for mode in ("auto", "push", "pull"):
        cfg_r = r_direction.DirectionConfig(mode=mode)
        cfg_p = direction.DirectionConfig(mode=mode)
        for _ in range(200):
            n = int(rng.integers(1, 5000))
            nnz_f, nnz_v = (int(v) for v in rng.integers(0, n + 1, 2))
            avg = float(rng.random() * 20)
            cur, locked = int(rng.integers(0, 2)), bool(rng.integers(0, 2))
            d_r, l_r = r_direction.next_direction(
                cfg_r, jnp.int8(cur), jnp.bool_(locked), jnp.int32(nnz_f),
                jnp.int32(nnz_v), n, avg)
            assert direction.next_direction(cfg_p, cur, locked, nnz_f, nnz_v,
                                            n, avg) == (int(d_r), bool(l_r))
    assert direction.check_monotone(("push", "pull", "pull", "push"))
    assert not direction.check_monotone(("pull", "push", "pull"))


# -- (c) the slice: bfs --------------------------------------------------------

@needs_reference
@pytest.mark.parametrize("backend,buckets", BACKEND_CASES)
@pytest.mark.parametrize("mode", DIRECTIONS)
@pytest.mark.parametrize("t", (8, 32))
def test_bfs_matches_reference(t, mode, backend, buckets):
    g = port_graph(t).with_backend(backend).with_buckets(buckets)
    res = bfs(g, SOURCE, direction=mode)
    assert_same_bfs(ref_bfs(t, mode), res)
    assert direction.check_monotone(res.directions)


@needs_reference
def test_bfs_auto_switches_direction():
    dirs = ref_bfs(8, "auto")[2]
    assert "pull" in dirs and "push" in dirs


@needs_reference
def test_bfs_row_chunk_matches_reference():
    g = port_graph(8).with_buckets(False)          # 25 tile rows
    assert_same_bfs(ref_bfs(8, "auto", row_chunk=5),
                    bfs(g, SOURCE, row_chunk=5, direction="auto"))


@needs_reference
@pytest.mark.parametrize("max_iters", (0, 1))
@pytest.mark.parametrize("backend", ("b2sr", "b2sr_cuda", "csr"))
def test_bfs_max_iters_matches_reference(backend, max_iters):
    g = port_graph(8).with_backend(backend)
    assert_same_bfs(ref_bfs(8, "pull", max_iters=max_iters),
                    bfs(g, SOURCE, max_iters=max_iters, direction="pull"))


def test_bfs_rejects_what_the_slice_does_not_run():
    g = port_graph(8)
    with pytest.raises(ValueError):
        bfs(g, SOURCE, max_iters=-1)
    with pytest.raises(ValueError, match="row_chunk"):
        bfs(g, [0, 1], row_chunk=2)
    with pytest.raises(ValueError, match="out of range"):
        bfs(g, [0, N])
    with pytest.raises(ValueError):
        bfs(g, N)


# -- (d) carried state: the reference's arrays as the port's graph ----------

def _reference_arrays(rg):
    out = {}
    for p, view in (("", rg), ("t.", rg.transposed())):
        e = view.ell
        out[p + "ell.tile_col_idx"] = np.asarray(e.tile_col_idx)
        out[p + "ell.bit_tiles"] = np.asarray(e.bit_tiles)
        out[p + "ell.row_n_tiles"] = np.asarray(e.row_n_tiles)
        b = view.buckets()
        for i in range(b.n_buckets):
            out[f"{p}buckets.{i}.col_idx"] = np.asarray(b.col_idx[i])
            out[f"{p}buckets.{i}.bit_tiles"] = np.asarray(b.bit_tiles[i])
            out[f"{p}buckets.{i}.rows"] = np.asarray(b.rows[i])
    return out


@needs_reference
@pytest.mark.parametrize("backend,buckets", BACKEND_CASES)
def test_from_reference_graph_bfs_matches(backend, buckets):
    rg = ref_graph(8)
    meta = {"tile_dim": 8, "n_rows": N, "n_cols": N, "nnz": rg.nnz}
    g = convert.from_reference(_reference_arrays(rg), meta, device="cpu",
                               backend=backend).with_buckets(buckets)
    pg = port_graph(8)
    for f in ("tile_row_ptr", "tile_col_idx", "bit_tiles"):
        assert torch.equal(getattr(g.b2sr, f), getattr(pg.b2sr, f))
    assert_same_bfs(ref_bfs(8, "auto"), bfs(g, SOURCE, direction="auto"))


@needs_reference
def test_from_reference_b2sr_arrays():
    from repro.core import b2sr as R
    r, c = graph_coo()
    m = R.coo_to_b2sr(r, c, N, N, 16)
    arrays = {f: np.asarray(getattr(m, f))
              for f in ("tile_row_ptr", "tile_col_idx", "bit_tiles")}
    meta = {"tile_dim": 16, "n_rows": N, "n_cols": N, "nnz": m.nnz}
    pm = convert.from_reference(arrays, meta, device="cpu")
    assert np.array_equal(to_numpy_u32(pm.bit_tiles), np.asarray(m.bit_tiles))
    assert torch.equal(pm.tile_row_ptr,
                       from_numpy_u32(np.asarray(m.tile_row_ptr), "cpu"))


# -- on the card ----------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("t", (8, 32))
def test_bfs_cuda_kernels_match_csr_on_card(cuda, t):
    r, c = graph_coo()
    g = GraphMatrix.from_coo(r, c, N, N, t, device=cuda, backend="b2sr_cuda")
    for mode in DIRECTIONS:
        before = bmv.bmv_bbb_push.launches + bmv.bmv_bbb_pull.launches
        res = bfs(g, SOURCE, direction=mode)
        assert (bmv.bmv_bbb_push.launches + bmv.bmv_bbb_pull.launches
                == before + res.n_iterations)
        want = bfs(g.with_backend("csr"), SOURCE, direction=mode)
        assert torch.equal(res.levels, want.levels)
        assert res.directions == want.directions
        plain = bfs(port_graph(t).with_backend("b2sr_cuda"), SOURCE,
                    direction=mode)
        assert torch.equal(res.levels.cpu(), plain.levels)
        assert (res.n_iterations, res.directions) == (plain.n_iterations,
                                                      plain.directions)
