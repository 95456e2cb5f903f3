"""PyTorch port vs the JAX reference: the push step over work items and
the dense SpMM that stages each item once.

The same numpy-seeded COO and operands go through ``repro`` and
``repro_torch`` on the CPU (``b2sr_cuda`` on a CPU graph runs the
kernels' plain versions). Tolerances: packed outputs are exact; dense
products are allclose with ``rtol=1e-5, atol=1e-5`` (each backend adds
at most a few dozen float32 terms per entry in its own order). The tests
marked ``cuda`` hold both kernels against their plain versions on the
card, with items of a few tiles so that every row is cut, and skip here.
"""

from __future__ import annotations

import functools
from unittest import mock

import numpy as np
import pytest

torch = pytest.importorskip("torch")

try:
    import jax.numpy as jnp
    from repro.core.descriptor import Descriptor as RDescriptor
    from repro.core.graphblas import GraphMatrix as RGraph
    from repro.core.operands import BitVector as RBitVector
except ImportError:                      # a card's machine without JAX
    jnp = None

from repro_torch.core.descriptor import Descriptor  # noqa: E402
from repro_torch.core.graphblas import GraphMatrix  # noqa: E402
from repro_torch.core.operands import BitVector  # noqa: E402
from repro_torch.core.semiring import SEMIRINGS  # noqa: E402
from repro_torch.core.words import to_numpy_u32  # noqa: E402
from repro_torch.kernels import items as wi  # noqa: E402
from repro_torch.kernels.bmv import bmv, ops as bmv_ops, ref  # noqa: E402
from repro_torch.kernels.spmm import ref as sref, spmm  # noqa: E402

needs_reference = pytest.mark.skipif(
    jnp is None, reason="the JAX reference package needs jax")

N = 90                                    # not a multiple of 8, 16 or 32
TOL = 1e-5
MASKS = ("none", "keep", "complement")


@functools.lru_cache(maxsize=None)
def directed_coo():
    """A directed graph with self-loops, repeated edges and a hub row
    (vertex 0 points at every third vertex), made by numpy."""
    rng = np.random.default_rng(17)
    r = rng.integers(0, N, 400)
    c = rng.integers(0, N, 400)
    loops = np.arange(0, N, 4)
    hub = np.arange(0, N, 3)
    rows = np.concatenate([r, loops, r[:60], np.zeros_like(hub)])
    cols = np.concatenate([c, loops, c[:60], hub])
    return rows.astype(np.int64), cols.astype(np.int64)


def port_graph(t: int, device="cpu"):
    r, c = directed_coo()
    return GraphMatrix.from_coo(r, c, N, N, t, device=device,
                                backend="b2sr_cuda")


@functools.lru_cache(maxsize=None)
def ref_graph(t: int, backend: str):
    r, c = directed_coo()
    return RGraph.from_coo(r, c, N, N, t).with_backend(backend)


# -- the push registry row passes the cut bmv_bbf keeps ---------------------------

def test_dense_vec_covers_d_up_to_the_widest_pass():
    assert [spmm.dense_vec(d) for d in (1, 16, 32, 33, 64, 65, 128, 1433)] \
        == [1, 1, 1, 2, 2, 4, 4, 8]
    m = port_graph(8).b2sr
    with pytest.raises(ValueError, match="vec"):
        spmm._spmm_dense(m, torch.ones(N, 3), None, 3)


@pytest.mark.parametrize("masked", (False, True))
def test_push_row_passes_the_kept_bbf_cut(masked):
    g = port_graph(8)
    bits = np.random.default_rng(3).random(N) < 0.3
    x = BitVector.pack(torch.from_numpy(bits), 8)
    desc = (Descriptor(mask=BitVector.pack(torch.from_numpy(~bits), 8),
                       complement=True) if masked else None)
    seen = {}

    def spy(name, fn):
        def wrapped(*args, **kw):
            seen[name] = kw.get("items")
            return fn(*args, **kw)
        return wrapped

    with mock.patch.object(bmv_ops, "bmv_bbb_push",
                           spy("push", bmv.bmv_bbb_push)), \
            mock.patch.object(bmv_ops, "bmv_bbf",
                              spy("count", bmv.bmv_bbf)):
        got = g.mxv(x, desc=desc)
        g.mxv(x, SEMIRINGS["arithmetic"], out_dtype=torch.int32)
    kept = wi.items_for(g, bmv.BBF_ITEM_WORK)
    assert seen["push"] is kept and seen["count"] is kept
    assert bmv.BBF_ITEM_WORK == spmm.BBF_ITEM_WORK
    want = g.with_backend("csr").mxv(x, desc=desc)
    assert torch.equal(got.words, want.words)


def test_push_plain_version_is_the_cpu_path_whatever_the_items():
    m = port_graph(4).b2sr
    rng = np.random.default_rng(5)
    x = BitVector.pack(torch.from_numpy(rng.random(N) < 0.2), 4).words
    args = (m.tile_row_ptr, m.tile_col_idx, m.bit_tiles, x)
    before = bmv.bmv_bbb_push.launches
    got = bmv.bmv_bbb_push(*args, None, t=4, items=wi.work_items(m, 3))
    assert torch.equal(got, ref.bmv_bbb_push(*args, None, t=4))
    assert bmv.bmv_bbb_push.launches == before


# -- the generic rows against the JAX reference ---------------------------------------

@needs_reference
@pytest.mark.parametrize("t", (4, 8, 32))
@pytest.mark.parametrize("case", MASKS)
def test_bool_mxv_on_directed_graph_matches_reference(t, case):
    rng = np.random.default_rng(t + len(case))
    xv = rng.random(N) < 0.2
    mv = rng.random(N) < 0.5
    rx = RBitVector.pack(jnp.asarray(xv), t, N)
    px = BitVector.pack(torch.from_numpy(xv), t, N)
    if case == "none":
        rdesc, pdesc = None, None
    else:
        comp = case == "complement"
        rdesc = RDescriptor(mask=RBitVector.pack(jnp.asarray(mv), t, N),
                            complement=comp)
        pdesc = Descriptor(mask=BitVector.pack(torch.from_numpy(mv), t, N),
                           complement=comp)
    for backend in ("b2sr", "b2sr_pallas"):
        want = ref_graph(t, backend).mxv(rx, desc=rdesc)
        got = port_graph(t).mxv(px, desc=pdesc)
        assert isinstance(got, BitVector) and got.n == N
        assert np.array_equal(np.asarray(want.words),
                              to_numpy_u32(got.words)), backend


@needs_reference
@pytest.mark.parametrize("t", (4, 32))
@pytest.mark.parametrize("d", (1, 33, 130))
def test_dense_mxm_matches_pallas_reference(t, d):
    x = np.random.default_rng(d).standard_normal((N, d)).astype(np.float32)
    want = np.asarray(ref_graph(t, "b2sr_pallas").mxm(jnp.asarray(x)))
    got = port_graph(t).mxm(torch.from_numpy(x))
    assert got.shape == (N, d)
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


# -- on the card ------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    return torch.device("cuda")


def _card_case(t: int, dev):
    """The directed graph joined with an R-MAT graph of 700 vertices: hub
    rows of many tiles, so items of a few tiles cut most rows."""
    from repro_torch.data import graphs as PG
    r, c = directed_coo()
    r2, c2 = PG.rmat_graph(700, avg_degree=12, seed=t)
    return GraphMatrix.from_coo(np.concatenate([r, r2]),
                                np.concatenate([c, c2]), 700, 700, t,
                                device=dev, backend="b2sr_cuda")


def _cuts(m, budget_bits: int):
    """The kernel's default cut, items of 3 tiles and items cut by a few
    set bits: the last two cut every row of more than a few tiles."""
    return (None, wi.work_items(m, 3),
            wi.work_items(m, budget_bits, by_bits=True))


@pytest.mark.cuda
@pytest.mark.parametrize("t", (4, 8, 16, 32))
def test_push_items_match_plain_on_card(cuda, t):
    g = _card_case(t, cuda)
    m = g.b2sr
    args = (m.tile_row_ptr, m.tile_col_idx, m.bit_tiles)
    rng = np.random.default_rng(t)
    for dens in (0.001, 0.1, 0.6, 1.0):
        x = g.pack(torch.as_tensor(rng.random(g.n_cols) < dens, device=cuda))
        mask = g.pack_rows(torch.as_tensor(rng.random(g.n_rows) < 0.5,
                                           device=cuda))
        for mk, comp in ((None, True), (mask, True), (mask, False)):
            want = ref.bmv_bbb_push(*args, x, mk, t=t, complement=comp)
            for items in _cuts(m, 5):
                before = bmv.bmv_bbb_push.launches
                got = bmv.bmv_bbb_push(*args, x, mk, t=t, complement=comp,
                                       items=items)
                assert bmv.bmv_bbb_push.launches == before + 1
                assert torch.equal(got, want), (dens, mk is None, comp)


@pytest.mark.cuda
@pytest.mark.parametrize("t", (4, 8, 16, 32))
def test_dense_items_match_plain_on_card(cuda, t):
    g = _card_case(t, cuda)
    m = g.b2sr
    rng = np.random.default_rng(t)
    for d in (1, 32, 33, 130, 1433):
        xi = torch.as_tensor(rng.integers(-3, 4, (700, d)).astype(
            np.float32), device=cuda)
        xf = torch.as_tensor(rng.standard_normal((700, d)).astype(
            np.float32), device=cuda)
        want_i = sref.spmm_dense(m, xi)
        want = sref.spmm_dense(m, xf).double()
        bound = TOL * sref.spmm_dense(m, xf.abs()).double()
        for items in _cuts(m, 40):
            before = spmm.spmm_dense.launches
            assert torch.equal(spmm.spmm_dense(m, xi, items=items), want_i)
            got = spmm.spmm_dense(m, xf, items=items)
            assert spmm.spmm_dense.launches == before + 2
            assert bool(((got.double() - want).abs() <= bound).all()), d
            # the same bits on a second launch and with every V
            again = spmm.spmm_dense(m, xf, items=items)
            assert torch.equal(got.view(torch.int32),
                               again.view(torch.int32))
            for vec in spmm.DENSE_VECS:
                other = spmm._spmm_dense(m, xf, items, vec)
                assert torch.equal(got.view(torch.int32),
                                   other.view(torch.int32)), vec


@pytest.mark.cuda
def test_dense_item_larger_than_a_stage_on_card(cuda):
    """One tile-row of 3,000 set bits as a single item: the kernel stages
    it in rounds and adds the rounds' sums."""
    t, n = 32, 3200
    rng = np.random.default_rng(9)
    cols = rng.choice(n, 3000, replace=False)
    rows = rng.integers(0, t, 3000)
    g = GraphMatrix.from_coo(rows, cols, n, n, t, device=cuda,
                             backend="b2sr_cuda")
    m = g.b2sr
    whole = wi.work_items(m, 1 << 20)
    halves = wi.work_items(m, -(-m.n_tiles // 2))   # a cut row, 2 items
    assert (whole.n_items, halves.n_items) == (1, 2)
    x = torch.as_tensor(rng.integers(-3, 4, (n, 70)).astype(np.float32),
                        device=cuda)
    want = sref.spmm_dense(m, x)
    for items in (whole, halves):
        assert torch.equal(spmm.spmm_dense(m, x, items=items), want)
