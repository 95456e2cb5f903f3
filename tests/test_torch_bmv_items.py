"""PyTorch port vs the JAX reference: the shared work-item cutter, the
``bmv_bff`` / ``bmv_bbf`` rows that take its items, and three port faults
of the ``b2sr_cuda`` rows (strided operands, gradients through the dense
``mxm`` row, the plan key's device).

The same numpy-seeded COO and operands go through ``repro`` and
``repro_torch`` on the CPU (``b2sr_cuda`` on a CPU graph runs the
kernels' plain versions). Tolerances: min-plus, max-times, count and
packed outputs are exact; arithmetic sums and gradients are allclose
with ``rtol=1e-5, atol=1e-5`` (each backend adds at most a few dozen
float32 terms per entry in its own order). The tests marked ``cuda`` hold
the kernels against their plain versions on the card, with items of a few
tiles so that every row is cut, and skip here.
"""

from __future__ import annotations

import functools
from unittest import mock

import numpy as np
import pytest

torch = pytest.importorskip("torch")

try:
    import jax
    import jax.numpy as jnp
    from repro.core.graphblas import GraphMatrix as RGraph
    from repro.core.operands import BitVector as RBitVector
    from repro.core.semiring import SEMIRINGS as R_SEMIRINGS
    from repro.gnn_bit import binarize as rbin
    from repro.kernels.bitpack import ops as rops
except ImportError:                      # a card's machine without JAX
    jnp = None

from repro_torch.core.graphblas import GraphMatrix  # noqa: E402
from repro_torch.core.operands import BitVector  # noqa: E402
from repro_torch.core.semiring import SEMIRINGS  # noqa: E402
from repro_torch.core.words import popcount, to_numpy_u32  # noqa: E402
from repro_torch.engine import planner  # noqa: E402
from repro_torch.gnn_bit import binarize  # noqa: E402
from repro_torch.kernels import items as wi  # noqa: E402
from repro_torch.kernels.bitpack import ops as bops  # noqa: E402
from repro_torch.kernels.bmv import bmv, ref  # noqa: E402
from repro_torch.kernels.spmm import spmm  # noqa: E402

needs_reference = pytest.mark.skipif(
    jnp is None, reason="the JAX reference package needs jax")

N = 90                                    # not a multiple of 8, 16 or 32
D = 5
TOL = 1e-5
SUM_TOL = 1e-5                            # |y - y_plain| <= SUM_TOL·(A·|a·x|)
BACKENDS = (("b2sr", "b2sr"), ("b2sr_cuda", "b2sr_pallas"), ("csr", "csr"))
MODES = {"arithmetic": "sum", "min_plus": "min_plus",
         "max_times": "max_times"}


@functools.lru_cache(maxsize=None)
def directed_coo():
    """A directed graph with self-loops, repeated edges and a hub row
    (vertex 0 points at every third vertex), made by numpy."""
    rng = np.random.default_rng(11)
    r = rng.integers(0, N, 400)
    c = rng.integers(0, N, 400)
    loops = np.arange(0, N, 4)
    hub = np.arange(0, N, 3)
    rows = np.concatenate([r, loops, r[:60], np.zeros_like(hub)])
    cols = np.concatenate([c, loops, c[:60], hub])
    return rows.astype(np.int64), cols.astype(np.int64)


@functools.lru_cache(maxsize=None)
def port_graph(t: int, backend: str = "b2sr_cuda"):
    r, c = directed_coo()
    return GraphMatrix.from_coo(r, c, N, N, t, device="cpu",
                                backend=backend)


@functools.lru_cache(maxsize=None)
def ref_graph(t: int, backend: str = "b2sr"):
    r, c = directed_coo()
    return RGraph.from_coo(r, c, N, N, t).with_backend(backend)


def dense_x(seed: int, shape=(N, D)) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


# -- the shared cutter ----------------------------------------------------------

@pytest.mark.parametrize("t", (4, 32))
@pytest.mark.parametrize("budget,by_bits", ((1, False), (3, False),
                                            (256, False), (5, True),
                                            (2048, True)))
def test_cut_puts_every_tile_in_one_item_within_budget(t, budget, by_bits):
    m = port_graph(t).b2sr
    it = wi.cut_rows(m.tile_row_ptr, m.bit_tiles, budget, by_bits)
    begin, rows = it.begin.long(), it.row.long()
    ptr = m.tile_row_ptr.long()
    # items tile the tiles in order: each tile lies in exactly one item
    owner = torch.repeat_interleave(torch.arange(it.n_items),
                                    begin[1:] - begin[:-1])
    assert torch.equal(owner, torch.sort(owner).values)
    assert owner.numel() == m.n_tiles
    assert bool((begin[:-1] >= ptr[rows]).all())
    assert bool((begin[1:] <= ptr[rows + 1]).all())
    # every non-empty row has an item; its items are its tiles
    per_row = torch.bincount(rows, minlength=m.n_tile_rows)
    assert torch.equal(per_row > 0, ptr[1:] > ptr[:-1])
    work = (popcount(m.bit_tiles).sum(1) + 1 if by_bits
            else torch.ones(m.n_tiles, dtype=torch.int64))
    for i in range(it.n_items):
        w = work[begin[i]:begin[i + 1]]
        assert int(w[:-1].sum()) < budget     # a single tile may exceed it
    # cut rows: their first slot and their count, slots in item order
    assert torch.equal(it.cut_row.long(), torch.nonzero(per_row > 1)
                       .flatten())
    assert torch.equal(it.cut_count.long(), per_row[it.cut_row.long()])
    cut = per_row[rows] > 1
    assert torch.equal(it.slot >= 0, cut)
    assert it.slot[cut].tolist() == list(range(it.n_slots))
    first = torch.searchsorted(rows, it.cut_row.long())
    assert torch.equal(it.slot[first], it.cut_first)
    again = wi.work_items(m, budget, by_bits)
    for f in ("row", "begin", "slot", "cut_row", "cut_first", "cut_count"):
        assert torch.equal(getattr(it, f), getattr(again, f)), f


def test_spmm_and_bmv_share_the_module_and_the_cached_cut():
    assert spmm.work_items is wi.work_items
    assert spmm.WorkItems is wi.WorkItems
    assert bmv.BFF_ITEM_WORK == spmm.DENSE_ITEM_WORK
    assert bmv.BBF_ITEM_WORK == spmm.BBF_ITEM_WORK
    r, c = directed_coo()
    g = GraphMatrix.from_coo(r, c, N, N, 8, device="cpu",
                             backend="b2sr_cuda")
    x = torch.from_numpy(dense_x(1))
    g.mxv(x[:, 0])                       # bmv_bff's row cuts and keeps
    kept = dict(g.fwd.cache)
    assert list(kept) == [("work_items", bmv.BFF_ITEM_WORK, True)]
    g.mxm(x)                             # spmm_dense reuses that cut
    assert g.fwd.cache == kept
    assert g.fwd.cache[("work_items", 2048, True)] is kept[
        ("work_items", 2048, True)]
    assert g.transposed().fwd.cache == {}     # the other orientation


# -- the b2sr_cuda mxv rows on a directed graph with self-loops --------------------

@needs_reference
@pytest.mark.parametrize("t", (4, 8, 32))
@pytest.mark.parametrize("semiring", tuple(MODES))
def test_dense_mxv_rows_on_directed_graph(t, semiring):
    rng = np.random.default_rng(t)
    x = rng.random(N).astype(np.float32)
    if semiring == "max_times":
        x = 2 * x - 1
    if semiring == "min_plus":
        x[rng.random(N) < 0.3] = np.inf
    for a_value in (1.0, 0.0):
        want = np.asarray(ref_graph(t).mxv(
            jnp.asarray(x), R_SEMIRINGS[semiring], a_value=a_value))
        got = port_graph(t).mxv(torch.from_numpy(x), SEMIRINGS[semiring],
                                a_value=a_value).numpy()
        if semiring == "arithmetic":
            np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
        else:
            assert np.array_equal(got, want), (t, semiring, a_value)


@needs_reference
@pytest.mark.parametrize("t", (4, 8, 32))
def test_count_mxv_row_on_directed_graph(t):
    rng = np.random.default_rng(t + 1)
    for dens in (0.05, 0.6):
        bits = rng.random(N) < dens
        want = np.asarray(ref_graph(t).mxv(
            RBitVector.pack(jnp.asarray(bits), t, N), R_SEMIRINGS[
                "arithmetic"], out_dtype=jnp.int32))
        got = port_graph(t).mxv(BitVector.pack(torch.from_numpy(bits), t),
                                SEMIRINGS["arithmetic"],
                                out_dtype=torch.int32)
        assert np.array_equal(got.numpy(), want), (t, dens)


# -- strided operands (a transposed view) ------------------------------------------

@needs_reference
@pytest.mark.parametrize("backend,ref_backend", BACKENDS)
def test_dense_mxm_takes_a_transposed_view(backend, ref_backend):
    x = dense_x(2, (D, N))
    want = np.asarray(ref_graph(8, ref_backend).mxm(jnp.asarray(x).T))
    xt = torch.from_numpy(x).T
    assert not xt.is_contiguous()
    got = port_graph(8, backend).mxm(xt)
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


@needs_reference
@pytest.mark.parametrize("t", (8, 32))
def test_packing_takes_a_transposed_view(t):
    x = dense_x(3, (D, N))
    x[x < 0.3] = 0.0
    xt = torch.from_numpy(x).T
    want = np.asarray(rops.pack_columns(jnp.asarray(x).T, t))
    assert np.array_equal(to_numpy_u32(bops.pack_columns(xt, t)), want)
    want = np.asarray(rbin.pack_activations(jnp.asarray(x).T, t).words)
    got = binarize.pack_activations(xt, t).words
    assert np.array_equal(to_numpy_u32(got), want)
    for col_major in (False, True):
        want = np.asarray(rops.pack_dense(jnp.asarray(x).T, t, col_major))
        got = bops.pack_dense(xt, t, col_major)
        assert np.array_equal(to_numpy_u32(got), want)


def test_mxv_rows_take_strided_vectors():
    g = port_graph(8)
    x = torch.from_numpy(dense_x(4, (N, 2)))
    want = g.with_backend("csr").mxv(x[:, 1].contiguous())
    torch.testing.assert_close(g.mxv(x[:, 1]), want, rtol=TOL, atol=TOL)
    bits = torch.from_numpy(dense_x(5, (N, 2)) > 0)
    words = torch.stack([BitVector.pack(bits[:, 0], 8).words] * 2, 1)
    xv = BitVector.from_words(words[:, 1], N, 8)
    assert not xv.words.is_contiguous()
    assert torch.equal(g.mxv(xv, SEMIRINGS["arithmetic"],
                             out_dtype=torch.int32),
                       g.with_backend("csr").mxv(
                           BitVector.pack(bits[:, 0], 8),
                           SEMIRINGS["arithmetic"], out_dtype=torch.int32))


# -- gradients through the dense mxm row -------------------------------------------

def _grad(g, x_np, w_np):
    x = torch.from_numpy(x_np).requires_grad_(True)
    (g.mxm(x) * torch.from_numpy(w_np)).sum().backward()
    return x.grad


@needs_reference
@pytest.mark.parametrize("t", (4, 32))
def test_dense_mxm_gradient_matches_csr_and_reference(t):
    x, w = dense_x(6), dense_x(7)
    got = _grad(port_graph(t), x, w)
    assert got is not None and got.shape == (N, D)
    want_csr = _grad(port_graph(t, "csr"), x, w)
    torch.testing.assert_close(got, want_csr, rtol=TOL, atol=TOL)
    rg = ref_graph(t)
    want_ref = jax.grad(lambda v: jnp.sum(rg.mxm(v) * jnp.asarray(w)))(
        jnp.asarray(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want_ref),
                               rtol=TOL, atol=TOL)
    # the gradient is Aᵀ·w through the stored transpose
    gt = port_graph(t).transposed()
    torch.testing.assert_close(
        got, gt.with_backend("csr").mxm(torch.from_numpy(w)),
        rtol=TOL, atol=TOL)


def test_dense_mxm_gradient_through_a_mask():
    g = port_graph(8)
    x, w = dense_x(8), dense_x(9)
    keep = torch.from_numpy(np.random.default_rng(1).random(N) < 0.5)
    from repro_torch.core.descriptor import Descriptor
    grads = []
    for gg in (g, g.with_backend("csr")):
        xx = torch.from_numpy(x).requires_grad_(True)
        y = gg.mxm(xx, desc=Descriptor(mask=keep, complement=False))
        (y * torch.from_numpy(w)).sum().backward()
        grads.append(xx.grad)
    torch.testing.assert_close(grads[0], grads[1], rtol=TOL, atol=TOL)


# -- the plan key's device ----------------------------------------------------------

def test_plan_keys_differ_by_device():
    g = port_graph(8)
    cpu_key = planner.plan_key(g, "msbfs", 32)
    assert cpu_key.device == "cpu"
    with mock.patch.object(GraphMatrix, "device",
                           new_callable=mock.PropertyMock,
                           return_value=torch.device("cuda", 0)):
        card_key = planner.plan_key(g, "msbfs", 32)
    assert card_key.device == "cuda:0"
    assert card_key != cpu_key
    assert card_key == planner.PlanKey(**{**cpu_key.__dict__,
                                          "device": "cuda:0"})


# -- on the card ------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    return torch.device("cuda")


def _card_case(t: int, dev):
    r, c = directed_coo()
    from repro_torch.data import graphs as PG
    r2, c2 = PG.rmat_graph(700, avg_degree=12, seed=t)
    rows = np.concatenate([r, r2])
    cols = np.concatenate([c, c2])
    return GraphMatrix.from_coo(rows, cols, 700, 700, t, device=dev,
                                backend="b2sr_cuda")


def _cuts(m):
    """The default cut, items of 3 tiles and items of 5 set bits: the last
    two cut every row of more than a few tiles."""
    return (None, wi.work_items(m, 3), wi.work_items(m, 5, by_bits=True))


@pytest.mark.cuda
@pytest.mark.parametrize("t", (4, 8, 16, 32))
def test_bff_items_match_plain_on_card(cuda, t):
    g = _card_case(t, cuda)
    m = g.b2sr
    args = (m.tile_row_ptr, m.tile_col_idx, m.bit_tiles)
    rng = np.random.default_rng(t)
    x3 = torch.as_tensor(rng.random((m.n_tile_cols, t), dtype=np.float32),
                         device=cuda)
    for mode in ref.BFF_MODES:
        xm = x3.clone()
        if mode == "min_plus":
            xm[torch.as_tensor(rng.random(xm.shape) < 0.3,
                               device=cuda)] = np.inf
        if mode == "max_times":
            xm = 2 * xm - 1
        for a_value in (1.0, 0.5):
            want = ref.bmv_bff(*args, xm, t=t, mode=mode, a_value=a_value)
            bound = SUM_TOL * ref.bmv_bff(*args, xm.abs(), t=t, mode="sum",
                                          a_value=abs(a_value))
            for items in _cuts(m):
                before = bmv.bmv_bff.launches
                got = bmv.bmv_bff(*args, xm, t=t, mode=mode, a_value=a_value,
                                  items=items)
                assert bmv.bmv_bff.launches == before + 1
                if mode != "sum":
                    assert torch.equal(got, want), (mode, a_value)
                    continue
                assert bool(((got - want).abs() <= bound).all()), a_value
                again = bmv.bmv_bff(*args, xm, t=t, mode=mode,
                                    a_value=a_value, items=items)
                assert torch.equal(got.view(torch.int32),
                                   again.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("t", (4, 8, 16, 32))
def test_bbf_items_match_plain_on_card(cuda, t):
    g = _card_case(t, cuda)
    m = g.b2sr
    rng = np.random.default_rng(t)
    for dens in (0.001, 0.05, 0.5, 1.0):
        x = g.pack(torch.as_tensor(rng.random(g.n_cols) < dens, device=cuda))
        args = (m.tile_row_ptr, m.tile_col_idx, m.bit_tiles, x)
        want = ref.bmv_bbf(*args, t=t)
        for items in _cuts(m):
            before = bmv.bmv_bbf.launches
            got = bmv.bmv_bbf(*args, t=t, items=items)
            assert bmv.bmv_bbf.launches == before + 1
            assert torch.equal(got, want), (dens, items is None)


@pytest.mark.cuda
def test_dense_mxm_gradient_on_card(cuda):
    g = _card_case(8, cuda)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((700, 33)).astype(np.float32)
    w = rng.standard_normal((700, 33)).astype(np.float32)
    grads = []
    for gg in (g, g.with_backend("csr")):
        xx = torch.as_tensor(x, device=cuda).requires_grad_(True)
        before = spmm.spmm_dense.launches
        (gg.mxm(xx) * torch.as_tensor(w, device=cuda)).sum().backward()
        if gg.backend == "b2sr_cuda":            # forward and backward
            assert spmm.spmm_dense.launches == before + 2
        grads.append(xx.grad)
    assert grads[0] is not None
    torch.testing.assert_close(grads[0], grads[1], rtol=TOL, atol=TOL)


@pytest.mark.cuda
def test_plans_kept_apart_by_device(cuda):
    from repro_torch.engine import msbfs
    r, c = directed_coo()
    cache = planner.PlanCache()
    srcs = np.array([0, 5, 17])
    levels = []
    for dev in ("cpu", cuda):
        g = GraphMatrix.from_coo(r, c, N, N, 8, device=dev,
                                 backend="b2sr_cuda")
        levels.append(msbfs(g, srcs, planner=cache).levels.cpu())
    assert cache.stats()["size"] == 2
    assert torch.equal(levels[0], levels[1])
