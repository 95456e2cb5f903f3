"""PyTorch port vs the JAX reference: the SpMM rows and their kernels.

The same numpy-seeded COO, frontiers and dense matrices go through
``repro`` and ``repro_torch`` on the CPU (``b2sr_cuda`` on a CPU graph
runs the kernels' plain versions). Each port backend is held against its
reference twin: ``b2sr`` against ``b2sr`` (buckets on and off),
``b2sr_cuda`` against ``b2sr_pallas`` (Pallas in interpret mode), ``csr``
against ``csr``. Packed frontier results must be equal bit for bit; dense
products within ``allclose(rtol=1e-5, atol=1e-6)`` with random X (the
sums run in another order) and exactly with small-integer X. The tests
marked ``cuda`` hold the kernels against their plain versions on the
card and skip here.
"""

from __future__ import annotations

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

try:
    import jax.numpy as jnp
    from repro.core import b2sr as R
    from repro.core.descriptor import Descriptor as RDescriptor
    from repro.core.graphblas import GraphMatrix as RGraph
    from repro.core.operands import FrontierBatch as RFrontier
except ImportError:                      # a card's machine without JAX
    jnp = None

from repro_torch import convert  # noqa: E402
from repro_torch.core import b2sr as P  # noqa: E402
from repro_torch.core import ops  # noqa: E402
from repro_torch.core.descriptor import Descriptor  # noqa: E402
from repro_torch.core.graphblas import GraphMatrix  # noqa: E402
from repro_torch.core.operands import BitVector, FrontierBatch  # noqa: E402
from repro_torch.core.semiring import SEMIRINGS  # noqa: E402
from repro_torch.core.words import (from_numpy_u32, popcount,  # noqa: E402
                                   to_numpy_u32)
from repro_torch.data import graphs as PG  # noqa: E402
from repro_torch.kernels.spmm import ref, spmm  # noqa: E402

needs_reference = pytest.mark.skipif(
    jnp is None, reason="the JAX reference package needs jax")

N = 44                                    # not a multiple of 8, 16 or 32
S = 37                                    # two source words, ragged
D = 5
#: (port backend, buckets, reference backend)
BACKEND_CASES = (("b2sr", False, "b2sr"), ("b2sr", True, "b2sr"),
                 ("b2sr_cuda", False, "b2sr_pallas"), ("csr", False, "csr"))
MASKS = ("none", "keep", "complement")


@functools.lru_cache(maxsize=None)
def coo():
    return PG.rmat_graph(N, avg_degree=5, seed=3)


@functools.lru_cache(maxsize=None)
def ref_graph(t: int, backend: str, buckets: bool):
    r, c = coo()
    return RGraph.from_coo(r, c, N, N, t).with_backend(backend).with_buckets(
        buckets)


@functools.lru_cache(maxsize=None)
def port_graph(t: int, backend: str, buckets: bool):
    r, c = coo()
    return GraphMatrix.from_coo(r, c, N, N, t, device="cpu",
                                backend=backend).with_buckets(buckets)


def bits(seed: int, p: float, shape=(N, S)) -> np.ndarray:
    return np.random.default_rng(seed).random(shape) < p


def frontiers(t: int, seed: int, p: float):
    """The same packed frontiers for both packages."""
    rf = RFrontier.pack(jnp.asarray(bits(seed, p)), t, N)
    pf = convert.frontier_from_reference(np.asarray(rf.words), N, S, t,
                                         device="cpu")
    return rf, pf


# -- frontier matrices ----------------------------------------------------------

@needs_reference
@pytest.mark.parametrize("s", (1, 33, 70))
@pytest.mark.parametrize("t", (4, 32))
def test_frontier_matrix_roundtrip_matches_reference(t, s):
    x = bits(t + s, 0.5, (70, s))
    want = np.asarray(R.pack_frontier_matrix(jnp.asarray(x), t, 70))
    got = P.pack_frontier_matrix(torch.from_numpy(x), t, 70)
    assert got.dtype == torch.int32 and tuple(got.shape) == want.shape
    assert np.array_equal(to_numpy_u32(got), want)
    back = P.unpack_frontier_matrix(got, 70, s, torch.bool)
    assert np.array_equal(back.numpy(), x)
    fb = FrontierBatch.pack(torch.from_numpy(x), t)
    assert fb.padded_width == 32 * -(-s // 32) and fb.n_sources == s
    assert np.array_equal(fb.unpack(torch.bool).numpy(), x)
    if s == 33:              # source 31 of a word is the sign bit
        assert bool((got[..., 0] < 0).any())


def test_frontier_batch_word_algebra():
    a = FrontierBatch.pack(torch.from_numpy(bits(1, 0.4)), 8)
    b = FrontierBatch.pack(torch.from_numpy(bits(2, 0.4)), 8)
    ua, ub = a.unpack(torch.bool), b.unpack(torch.bool)
    assert torch.equal((a | b).unpack(torch.bool), ua | ub)
    assert torch.equal((a & b).unpack(torch.bool), ua & ub)
    assert torch.equal((a & ~b).unpack(torch.bool), ua & ~ub)
    assert bool(a.any()) and not bool((a & ~a).any())
    with pytest.raises(TypeError, match="int32"):
        FrontierBatch.from_words(a.words.to(torch.int64), N, S, 8)


# -- the frontier rows through GraphMatrix.mxm ------------------------------------

def _mask_kw(t: int, mask: str, pull: bool = False):
    if mask == "none":
        return {}, {}
    rm, pm = frontiers(t, 7, 0.5)
    comp = mask == "complement"
    d = "pull" if pull else None
    return (dict(desc=RDescriptor(mask=rm, complement=comp, direction=d)),
            dict(desc=Descriptor(mask=pm, complement=comp, direction=d)))


@needs_reference
@pytest.mark.parametrize("mask", MASKS)
@pytest.mark.parametrize("backend,buckets,ref_backend", BACKEND_CASES)
@pytest.mark.parametrize("t", (4, 8, 32))
def test_frontier_rows_match_reference(t, backend, buckets, ref_backend,
                                       mask):
    rf, pf = frontiers(t, t, 0.3)
    rkw, pkw = _mask_kw(t, mask)
    want = ref_graph(t, ref_backend, buckets).mxm(rf, **rkw)
    got = port_graph(t, backend, buckets).mxm(pf, **pkw)
    assert isinstance(got, FrontierBatch)
    assert (got.n, got.n_sources, got.tile_dim) == (N, S, t)
    assert np.array_equal(to_numpy_u32(got.words), np.asarray(want.words))


@needs_reference
@pytest.mark.parametrize("mask", ("keep", "complement"))
@pytest.mark.parametrize("backend,buckets,ref_backend", BACKEND_CASES)
def test_frontier_pull_rows_match_reference(backend, buckets, ref_backend,
                                            mask):
    t = 8
    rf, pf = frontiers(t, 3, 0.3)
    rkw, pkw = _mask_kw(t, mask, pull=True)
    want = ref_graph(t, ref_backend, buckets).mxm(rf, **rkw)
    got = port_graph(t, backend, buckets).mxm(pf, **pkw)
    assert np.array_equal(to_numpy_u32(got.words), np.asarray(want.words))


@needs_reference
@pytest.mark.parametrize("backend,buckets,ref_backend", BACKEND_CASES)
def test_frontier_replace_false_merges_out(backend, buckets, ref_backend):
    t = 8
    rf, pf = frontiers(t, 5, 0.3)
    rm, pm = frontiers(t, 6, 0.5)
    ro, po = frontiers(t, 8, 0.5)
    want = ref_graph(t, ref_backend, buckets).mxm(
        rf, desc=RDescriptor(mask=rm, complement=True, replace=False),
        out=ro)
    got = port_graph(t, backend, buckets).mxm(
        pf, desc=Descriptor(mask=pm, complement=True, replace=False), out=po)
    assert np.array_equal(to_numpy_u32(got.words), np.asarray(want.words))


def test_frontier_column_equals_single_source_mxv():
    t = 8
    g = port_graph(t, "b2sr", True)
    f = bits(11, 0.3)
    y = g.mxm(FrontierBatch.pack(torch.from_numpy(f), t)).unpack(torch.bool)
    for col in (0, 31, 36):
        x = BitVector.pack(torch.from_numpy(f[:, col]), t, N)
        assert torch.equal(y[:, col], g.mxv(x).unpack(torch.bool))


# -- the dense rows -----------------------------------------------------------------

def dense_x(seed: int, integer: bool) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if integer:
        return rng.integers(-3, 4, (N, D)).astype(np.float32)
    return rng.standard_normal((N, D)).astype(np.float32)


@needs_reference
@pytest.mark.parametrize("mask", ("none", "rows", "matrix_complement"))
@pytest.mark.parametrize("backend,buckets,ref_backend", BACKEND_CASES)
@pytest.mark.parametrize("t", (4, 32))
def test_dense_rows_match_reference(t, backend, buckets, ref_backend, mask):
    rg = ref_graph(t, ref_backend, buckets)
    pg = port_graph(t, backend, buckets)
    if mask == "rows":
        m = bits(9, 0.5, (N,))
        rkw = dict(mask=jnp.asarray(m))
        pkw = dict(mask=torch.from_numpy(m))
    elif mask == "matrix_complement":
        m = bits(9, 0.5, (N, D))
        rkw = dict(mask=jnp.asarray(m), complement=True)
        pkw = dict(mask=torch.from_numpy(m), complement=True)
    else:
        rkw = pkw = {}
    for integer in (True, False):
        x = dense_x(t, integer)
        want = np.asarray(rg.mxm(jnp.asarray(x), **rkw))
        got = pg.mxm(torch.from_numpy(x), **pkw)
        assert got.dtype == torch.float32 and tuple(got.shape) == (N, D)
        if integer:
            assert np.array_equal(got.numpy(), want)
        else:
            np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                                       atol=1e-6)


@needs_reference
@pytest.mark.parametrize("backend,buckets,ref_backend", BACKEND_CASES)
def test_dense_replace_false_and_bitvector_mask(backend, buckets,
                                                ref_backend):
    from repro.core.operands import BitVector as RBitVector
    t = 8
    m = bits(4, 0.5, (N,))
    x = dense_x(2, True)
    out = dense_x(3, True)
    want = ref_graph(t, ref_backend, buckets).mxm(
        jnp.asarray(x), desc=RDescriptor(mask=RBitVector.pack(
            jnp.asarray(m), t, N), replace=False), out=jnp.asarray(out))
    got = port_graph(t, backend, buckets).mxm(
        torch.from_numpy(x), desc=Descriptor(mask=BitVector.pack(
            torch.from_numpy(m), t, N), replace=False),
        out=torch.from_numpy(out))
    assert np.array_equal(got.numpy(), np.asarray(want))


def test_mxm_operand_checks():
    g = port_graph(8, "b2sr", True)
    fb = FrontierBatch.pack(torch.from_numpy(bits(1, 0.3)), 8)
    with pytest.raises(TypeError, match="FrontierBatch mask"):
        g.mxm(fb, mask=BitVector.pack(torch.ones(N), 8, N))
    with pytest.raises(ValueError, match="tile_dim"):
        g.mxm(FrontierBatch.pack(torch.from_numpy(bits(1, 0.3)), 4))
    with pytest.raises(ValueError, match="length"):
        g.mxm(FrontierBatch.pack(torch.from_numpy(bits(1, 0.3, (N + 8, S))),
                                 8))
    with pytest.raises(ValueError, match="dense operand"):
        g.mxm(torch.ones(N + 1, 2))
    with pytest.raises(NotImplementedError, match="boolean"):
        g.mxm(fb, SEMIRINGS["arithmetic"])
    with pytest.raises(NotImplementedError, match="arithmetic"):
        g.mxm(torch.ones(N, 2), SEMIRINGS["min_plus"])
    with pytest.raises(ValueError, match="pull"):
        g.mxm(torch.ones(N, 2), desc=Descriptor(direction="pull"))
    with pytest.raises(ValueError, match="pull"):
        g.mxm(fb, desc=Descriptor(direction="pull"))


# -- the word schemes ------------------------------------------------------------------

@pytest.mark.parametrize("t", (4, 16))
def test_frontier_schemes_bucketed_and_masked(t):
    g = port_graph(t, "b2sr", True)
    f = P.pack_frontier_matrix(torch.from_numpy(bits(t, 0.3)), t, N)
    m = P.pack_frontier_matrix(torch.from_numpy(bits(t + 1, 0.5)), t, N)
    y = ops.spmm_bin_bin_bin(g.ell, f)
    assert torch.equal(ops.spmm_bin_bin_bin_bucketed(g.buckets(), f), y)
    half = g.ell.n_tile_rows // 2 if g.ell.n_tile_rows % 2 == 0 else None
    if half:
        assert torch.equal(ops.spmm_bin_bin_bin(g.ell, f, row_chunk=half), y)
    for comp in (True, False):
        want = y & (~m if comp else m)
        assert torch.equal(ops.spmm_bin_bin_bin_masked(g.ell, f, m, comp),
                           want)
        assert torch.equal(ops.spmm_bin_bin_bin_bucketed_masked(
            g.buckets(), f, m, comp), want)
        assert torch.equal(ops.spmm_bin_bin_bin_pull(g.ell, f, m, comp),
                           want)
        assert torch.equal(ops.spmm_bin_bin_bin_pull_bucketed(
            g.buckets(), f, m, comp), want)
    x = torch.from_numpy(dense_x(t, True))
    assert torch.equal(ops.spmm_b2sr_bucketed(g.buckets(), x),
                       ops.spmm_b2sr(g.ell, x))


# -- the plain kernels against the Pallas kernels ------------------------------------------

@needs_reference
@pytest.mark.parametrize("t", (4, 8, 32))
def test_plain_kernels_match_pallas(t):
    from repro.kernels.spmm import ops as kops
    r, c = coo()
    ell = R.to_ell(R.coo_to_b2sr(r, c, N, N, t))
    m = port_graph(t, "b2sr_cuda", False).b2sr
    f, mk = bits(t, 0.4), bits(t + 5, 0.5)
    rf = R.pack_frontier_matrix(jnp.asarray(f), t, N)
    rm = R.pack_frontier_matrix(jnp.asarray(mk), t, N)
    pf = from_numpy_u32(np.asarray(rf), "cpu")
    pm = from_numpy_u32(np.asarray(rm), "cpu")
    for mask, comp in ((None, True), (pm, True), (pm, False)):
        want = kops.spmm_bin_bin_bin(ell, rf, None if mask is None else rm,
                                     comp, interpret=True)
        got = ref.spmm_bbb(m, pf, mask, complement=comp)
        assert np.array_equal(to_numpy_u32(got), np.asarray(want))
    x = dense_x(t, True)
    want = kops.spmm(ell, jnp.asarray(x), interpret=True)
    assert np.array_equal(ref.spmm_dense(m, torch.from_numpy(x)).numpy(),
                          np.asarray(want))


@pytest.mark.parametrize("budget,by_bits", ((1, False), (2, False),
                                            (1024, False), (3, True),
                                            (40, True)))
def test_work_items_cover_every_tile(budget, by_bits):
    m = port_graph(4, "b2sr_cuda", False).b2sr
    it = spmm.work_items(m, budget, by_bits)
    begin = it.begin.long()
    assert int(begin[0]) == 0 and int(begin[-1]) == m.n_tiles
    rows = it.row.long()
    ptr = m.tile_row_ptr.long()
    assert bool((begin[1:] > begin[:-1]).all())
    assert bool((begin[:-1] >= ptr[rows]).all())
    assert bool((begin[1:] <= ptr[rows + 1]).all())
    # an item's work stays within the budget but for its last tile
    work = (popcount(m.bit_tiles).sum(1) + 1 if by_bits
            else torch.ones(m.n_tiles, dtype=torch.int64))
    for i in range(it.n_items):
        w = work[begin[i]:begin[i + 1]]
        assert int(w[:-1].sum()) < budget
    per_row = torch.bincount(rows, minlength=m.n_tile_rows)
    assert torch.equal(per_row[it.cut_row.long()], it.cut_count.long())
    cut = per_row[rows] > 1
    assert torch.equal(it.slot >= 0, cut)
    assert it.n_slots == int(cut.sum())
    if it.n_slots:
        assert sorted(it.slot[cut].tolist()) == list(range(it.n_slots))
        assert torch.equal(it.slot[torch.searchsorted(
            rows, it.cut_row.long())], it.cut_first)


def test_wrappers_check_inputs_and_count_only_launches():
    m = port_graph(8, "b2sr_cuda", False).b2sr
    f = P.pack_frontier_matrix(torch.from_numpy(bits(1, 0.3)), 8, N)
    with pytest.raises(ValueError, match="shape"):
        spmm.spmm_bbb(m, f[:-1])
    with pytest.raises(TypeError, match="int32"):
        spmm.spmm_bbb(m, f.to(torch.int64))
    with pytest.raises(ValueError, match="mask shape"):
        spmm.spmm_bbb(m, f, f[:, :, :1].contiguous())
    with pytest.raises(TypeError, match="float32"):
        spmm.spmm_dense(m, torch.ones(N, 2, dtype=torch.float64))
    with pytest.raises(ValueError, match="x shape"):
        spmm.spmm_dense(m, torch.ones(N - 1, 2))
    before = (spmm.spmm_bbb.launches, spmm.spmm_dense.launches)
    spmm.spmm_bbb(m, f)                     # CPU: the plain versions
    spmm.spmm_dense(m, torch.ones(N, 2))
    assert (spmm.spmm_bbb.launches, spmm.spmm_dense.launches) == before


# -- on the card ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    return torch.device("cuda")


def _card_graph(t: int, dev, n: int = 700):
    r, c = PG.rmat_graph(n, avg_degree=12, seed=t)
    return P.coo_to_b2sr(r, c, n, n, t, dev), n


@pytest.mark.cuda
@pytest.mark.parametrize("t", (4, 8, 16, 32))
def test_spmm_bbb_matches_plain_on_card(cuda, t):
    m, n = _card_graph(t, cuda)
    cut = spmm.work_items(m, 3)       # rows merged from several items
    for s in (1, 33, 70):
        f = P.pack_frontier_matrix(torch.from_numpy(
            bits(s, 0.05, (n, s))).to(cuda), t, n)
        mk = P.pack_frontier_matrix(torch.from_numpy(
            bits(s + 1, 0.5, (n, s))).to(cuda), t, n)
        for mask, comp in ((None, True), (mk, True), (mk, False)):
            want = ref.spmm_bbb(m, f, mask, complement=comp)
            for items in (None, cut):
                before = spmm.spmm_bbb.launches
                got = spmm.spmm_bbb(m, f, mask, complement=comp, items=items)
                assert spmm.spmm_bbb.launches == before + 1
                assert torch.equal(got, want), (t, s, mask is None, comp)


@pytest.mark.cuda
@pytest.mark.parametrize("t", (4, 8, 16, 32))
def test_spmm_dense_matches_plain_on_card(cuda, t):
    m, n = _card_graph(t, cuda)
    items = spmm.work_items(m, spmm.DENSE_ITEM_WORK, by_bits=True)
    small = spmm.work_items(m, 1)          # every row cut: the merge pass
    rng = np.random.default_rng(t)
    for d in (1, 32, 33, 64):
        xi = torch.from_numpy(rng.integers(-3, 4, (n, d)).astype(
            np.float32)).to(cuda)
        before = spmm.spmm_dense.launches
        assert torch.equal(spmm.spmm_dense(m, xi, items=items),
                           ref.spmm_dense(m, xi))
        small_items = spmm.spmm_dense(m, xi, items=small)
        assert spmm.spmm_dense.launches == before + 2
        assert torch.equal(small_items, ref.spmm_dense(m, xi))
        xf = torch.from_numpy(rng.standard_normal((n, d)).astype(
            np.float32)).to(cuda)
        got = spmm.spmm_dense(m, xf, items=items).double()
        want = ref.spmm_dense(m, xf).double()
        bound = 1e-5 * ref.spmm_dense(m, xf.abs()).double()
        assert bool(((got - want).abs() <= bound).all()), (t, d)


@pytest.mark.cuda
def test_cuda_rows_launch_the_kernels(cuda):
    t = 8
    r, c = coo()
    g = GraphMatrix.from_coo(r, c, N, N, t, backend="b2sr_cuda", device=cuda)
    gc = g.with_backend("csr")
    f = FrontierBatch.pack(torch.from_numpy(bits(1, 0.3)).to(cuda), t)
    mk = FrontierBatch.pack(torch.from_numpy(bits(2, 0.5)).to(cuda), t)
    x = torch.from_numpy(dense_x(1, True)).to(cuda)
    before = (spmm.spmm_bbb.launches, spmm.spmm_dense.launches)
    for desc in (None, Descriptor(mask=mk, complement=True),
                 Descriptor(mask=mk, complement=True, direction="pull")):
        assert torch.equal(g.mxm(f, desc=desc).words,
                           gc.mxm(f, desc=desc).words)
    assert torch.equal(g.mxm(x), gc.mxm(x))
    assert (spmm.spmm_bbb.launches, spmm.spmm_dense.launches) == (
        before[0] + 3, before[1] + 1)
