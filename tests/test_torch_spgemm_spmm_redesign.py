"""PyTorch port vs the JAX reference: the boolean SpGEMM (``spgemm_bbb``)
and the multi-frontier traversal (``spmm_bbb``) on the inputs their
redesigned kernels treat apart, and the SpGEMM wrapper's host-side steps.

The same numpy-made COO goes through ``repro`` (``b2sr_pallas``, Pallas in
interpret mode) and ``repro_torch`` on the CPU (``b2sr_cuda`` on a CPU
graph runs the plain versions): keep and complement masks, a mask that
zeroes whole product tiles, a graph whose tile pairs all meet in nothing
(every product tile zero), a banded road grid, t = 4, 8, 16, 32; frontier
batches over cut tile-rows, more than 32 source words, an empty frontier
and an all-ones mask. Every result is bits: equal. The tests marked
``cuda`` run the same cases on the card against the plain versions, and
add a C row that takes many rounds of slots, a B at the shared-memory
bitmap's width limit and the compaction of zero tiles; they skip here.
"""

from __future__ import annotations

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

try:
    import jax.numpy as jnp
    from repro.core import b2sr as R
    from repro.core.graphblas import GraphMatrix as RGraph
    from repro.kernels.spmm import ops as r_spmm
except ImportError:                      # a card's machine without JAX
    jnp = None

from repro_torch.core import b2sr as P  # noqa: E402
from repro_torch.core.graphblas import GraphMatrix  # noqa: E402
from repro_torch.core.words import from_numpy_u32, to_numpy_u32  # noqa: E402
from repro_torch.data import graphs as PG  # noqa: E402
from repro_torch.kernels import common  # noqa: E402
from repro_torch.kernels.items import work_items  # noqa: E402
from repro_torch.kernels.spgemm import ref, spgemm  # noqa: E402
from repro_torch.kernels.spmm import ref as sref, spmm  # noqa: E402

needs_reference = pytest.mark.skipif(
    jnp is None, reason="the JAX reference package needs jax")

TILE_DIMS = (4, 8, 16, 32)
MASKS = ("none", "keep", "complement", "zeroing")


@functools.lru_cache(maxsize=None)
def graph_coo(name: str):
    """(rows, cols, n) made by numpy: ``road`` a banded grid; ``odd_even``
    edges from even to odd vertices only, so every pair of tiles that
    meets (A(I, X), A(X, J)) ORs nothing in (A² is empty); ``mixed`` an
    R-MAT graph with such edges added."""
    if name == "road":
        r, c = PG.road_graph(7)
        return r, c, 49
    rng = np.random.default_rng(5)
    n = 60
    ev = 2 * rng.integers(0, n // 2, 400)
    od = 2 * rng.integers(0, n // 2, 400) + 1
    if name == "odd_even":
        return ev, od, n
    r, c = PG.rmat_graph(n, avg_degree=4, seed=6)
    return np.concatenate([r, ev]), np.concatenate([c, od]), n


@functools.lru_cache(maxsize=None)
def mask_coo(name: str, kind: str, t: int):
    """A mask of the product's shape: ``keep``/``complement`` a random
    half of A²'s entries; ``zeroing`` every entry of A² in its even tile
    columns, so C⟨¬M⟩ has whole tiles that come out zero."""
    r, c, n = graph_coo(name)
    a = np.zeros((n, n), np.int64)
    a[r, c] = 1
    rr, cc = np.nonzero(a @ a)
    if kind == "zeroing":
        sel = (cc // t) % 2 == 0
    else:
        sel = np.random.default_rng(7).random(rr.size) < 0.5
    return rr[sel], cc[sel]


def port_arrays(m):
    return (m.tile_row_ptr.cpu().numpy(), m.tile_col_idx.cpu().numpy(),
            to_numpy_u32(m.bit_tiles.cpu()), m.nnz)


def ref_arrays(g):
    """The reference result's B2SR arrays, from its ELL view."""
    ell = g.ell
    col = np.asarray(ell.tile_col_idx)
    valid = col >= 0
    ptr = np.concatenate([[0], np.cumsum(np.asarray(ell.row_n_tiles))])
    return (ptr.astype(np.int32), col[valid],
            np.asarray(ell.bit_tiles)[valid], g.nnz)


def assert_same(want, got):
    for w, g in zip(want, got):
        assert np.array_equal(np.asarray(w), np.asarray(g))


# -- the b2sr_cuda mxm row against b2sr_pallas -------------------------------

@needs_reference
@pytest.mark.parametrize("mask", MASKS)
@pytest.mark.parametrize("name", ("road", "odd_even", "mixed"))
@pytest.mark.parametrize("t", TILE_DIMS)
def test_mxm_row_matches_reference(t, name, mask):
    r, c, n = graph_coo(name)
    rg = RGraph.from_coo(r, c, n, n, t).with_backend("b2sr_pallas")
    pg = GraphMatrix.from_coo(r, c, n, n, t, device="cpu",
                              backend="b2sr_cuda")
    kw, pkw = {}, {}
    if mask != "none":
        mr, mc = mask_coo(name, "zeroing" if mask == "zeroing" else "half", t)
        comp = mask != "keep"
        kw = dict(mask=RGraph.from_coo(mr, mc, n, n, t), complement=comp)
        pkw = dict(mask=GraphMatrix.from_coo(mr, mc, n, n, t, device="cpu"),
                   complement=comp)
    want = rg.mxm(rg, **kw)
    got = pg.mxm(pg, **pkw)
    assert_same(ref_arrays(want), port_arrays(got.b2sr))
    if name == "odd_even" and mask == "none":
        assert got.b2sr.n_tiles == 0 and got.nnz == 0
    if mask == "zeroing" and name != "odd_even":  # A² has tiles; none
        # of C lies in an even tile column
        cols = got.b2sr.tile_col_idx
        assert got.b2sr.n_tiles and bool((cols % 2 == 1).all())


# -- the b2sr_cuda frontier row against the Pallas kernel ------------------

def _frontier_case(case: str, n: int, rng):
    """(sources, frontier bits, mask bits or None, complement)."""
    s = 1056 if case == "wide" else 40     # 33 source words, and 2
    f = rng.random((n, s)) < 0.1
    mk = rng.random((n, s)) < 0.5
    if case == "empty":
        f[:] = False
    if case.startswith("all_ones"):
        mk[:] = True
    return s, f, (None if case == "no_mask" else mk), \
        case != "all_ones_keep"


@needs_reference
@pytest.mark.parametrize("case", ("cut", "wide", "empty", "no_mask",
                                  "all_ones_keep", "all_ones_complement"))
@pytest.mark.parametrize("t", (8, 32))
def test_frontier_row_matches_reference(t, case):
    r, c, n = graph_coo("mixed")
    ell = R.to_ell(R.coo_to_b2sr(r, c, n, n, t))
    m = P.coo_to_b2sr(r, c, n, n, t, "cpu")
    s, f, mk, comp = _frontier_case(case, n, np.random.default_rng(t))
    rf = R.pack_frontier_matrix(jnp.asarray(f), t, n)
    rm = None if mk is None else R.pack_frontier_matrix(jnp.asarray(mk), t, n)
    want = np.asarray(r_spmm.spmm_bin_bin_bin(ell, rf, rm, comp,
                                              interpret=True))
    pf = from_numpy_u32(np.asarray(rf), "cpu")
    pm = None if rm is None else from_numpy_u32(np.asarray(rm), "cpu")
    items = work_items(m, 2) if case == "cut" else None
    got = spmm.spmm_bbb(m, pf, pm, complement=comp, items=items)
    assert np.array_equal(to_numpy_u32(got), want)
    if case in ("empty", "all_ones_complement"):
        assert not want.any()


# -- the SpGEMM wrapper's host-side steps ------------------------------------

def test_compact_keeps_every_slot_when_each_is_flagged():
    col = torch.tensor([3, 5, 0, 2], dtype=torch.int32)
    tiles = torch.arange(8, dtype=torch.int32).view(4, 2) + 1
    flag = torch.ones(4, dtype=torch.uint8)
    ptr, c, t, nnz = spgemm.compact(col, tiles, flag,
                                    torch.tensor([2, 0, 2]),
                                    torch.tensor([5, 0, 7]))
    assert ptr.tolist() == [0, 2, 2, 4] and ptr.dtype == torch.int32
    assert c is col and t is tiles and nnz == 12   # no copy


def test_compact_drops_the_zero_tiles_in_order():
    col = torch.tensor([3, 5, 0, 2, 7], dtype=torch.int32)
    tiles = torch.tensor([[1, 0], [0, 0], [0, 4], [0, 0], [9, 9]],
                         dtype=torch.int32)
    flag = (tiles != 0).any(1).to(torch.uint8)
    ptr, c, t, _ = spgemm.compact(col, tiles, flag, torch.tensor([1, 1, 1]),
                                  torch.tensor([1, 1, 2]))
    assert ptr.tolist() == [0, 1, 2, 3]
    assert c.tolist() == [3, 0, 7]
    assert t.tolist() == [[1, 0], [0, 4], [9, 9]]


@pytest.mark.parametrize("name", ("road", "mixed"))
def test_block_threads_follow_row_length(name):
    """The window pass scans a row with a thread where A's rows are short
    on average, with a warp where they are long."""
    r, c, n = graph_coo(name)
    assert not spgemm.window_by_warps(P.coo_to_b2sr(r, c, n, n, 8, "cpu"))
    r, c = PG.rmat_graph(2048, avg_degree=64, seed=1)   # rows of ~61 tiles
    assert spgemm.window_by_warps(P.coo_to_b2sr(r, c, 2048, 2048, 4, "cpu"))


# -- on the card ---------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    return torch.device("cuda")


def _same_b2sr(got, want):
    for part in ("tile_row_ptr", "tile_col_idx", "bit_tiles"):
        assert torch.equal(getattr(got, part), getattr(want, part)), part
    assert got.nnz == want.nnz


def _card_cases(t, dev):
    """(A, mask, complement) for every graph and mask of the CPU cases and
    a larger R-MAT graph with a hub row."""
    out = []
    for name in ("road", "odd_even", "mixed", "rmat"):
        if name == "rmat":
            r, c = PG.rmat_graph(900, avg_degree=24, seed=t)
            n = 900
        else:
            r, c, n = graph_coo(name)
        a = P.coo_to_b2sr(r, c, n, n, t, dev)
        out.append((name, a, None, False))
        if name == "rmat":
            continue
        for mask in MASKS[1:]:
            mr, mc = mask_coo(name, "zeroing" if mask == "zeroing" else "half",
                              t)
            out.append((f"{name}/{mask}", a,
                        P.coo_to_b2sr(mr, mc, n, n, t, dev), mask != "keep"))
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("t", TILE_DIMS)
def test_spgemm_matches_plain_on_card(cuda, t):
    for name, a, mk, comp in _card_cases(t, cuda):
        want = ref.spgemm_bbb(a, a, mk, complement=comp)
        before = spgemm.spgemm_bbb.launches
        got = spgemm.spgemm_bbb(a, a, mk, complement=comp)
        assert spgemm.spgemm_bbb.launches == before + 1
        _same_b2sr(got, want)
        # the compaction leaves no all-zero tile
        assert bool((got.bit_tiles != 0).any(1).all()), name


@pytest.mark.cuda
@pytest.mark.parametrize("threads,slots", ((32, 1), (64, 3), (128, 8),
                                           (512, 5), (1024, 1024)))
def test_spgemm_rounds_and_block_sizes_on_card(cuda, threads, slots):
    """Rows with more slots than a round holds take several rounds; every
    block size and round, with every row heavy, none or some, gives the
    plain version's C."""
    for t in (4, 32):
        for name, a, mk, comp in _card_cases(t, cuda):
            want = ref.spgemm_bbb(a, a, mk, complement=comp)
            for heavy in (0, spgemm.NEVER, 40):
                events = []
                got = spgemm._spgemm_bbb(a, a, mk, comp, heavy,
                                         (threads, threads), (slots, slots),
                                         events)
                _same_b2sr(got, want)
                for e in events:
                    if e[0].startswith("fill/"):     # C has a tile
                        assert e[3][0] == threads and 1 <= e[3][1] <= slots
                names = {e[0] for e in events}
                if heavy == 0:
                    assert "count/light" not in names, name
                if heavy == spgemm.NEVER:
                    assert "count/heavy" not in names, name


def _road_with_hubs(side: int, hubs: int, out_degree: int, seed: int):
    """A road grid with ``hubs`` vertices given ``out_degree`` edges each
    to random vertices (directed: no column is a hub's), so a few
    tile-rows of A are long among short ones."""
    r, c = PG.road_graph(side)
    n = side * side
    rng = np.random.default_rng(seed)
    hub = rng.choice(n, hubs, replace=False)
    hr = np.repeat(hub, out_degree)
    hc = rng.integers(0, n, hubs * out_degree)
    return np.concatenate([r, hr]), np.concatenate([c, hc]), n


@pytest.mark.cuda
@pytest.mark.parametrize("t", (4, 32))
def test_spgemm_hub_rows_among_short_rows_on_card(cuda, t):
    """A road grid with a few hub rows: the hub rows go to the heavy list
    (wide blocks), the rest to the light one, and C is the plain
    version's."""
    r, c, n = _road_with_hubs(256, 4, 8000, t)   # hub rows: > 4096 pairs
    a = P.coo_to_b2sr(r, c, n, n, t, cuda)
    assert not spgemm.window_by_warps(a)
    for mk, comp in ((None, False), (a, True)):
        events = []
        got = spgemm._spgemm_bbb(a, a, mk, comp, events=events)
        _same_b2sr(got, ref.spgemm_bbb(a, a, mk, complement=comp))
        shapes = {e[0]: e[3] for e in events}
        assert shapes["count/heavy"][0] == spgemm.THREADS_LONG
        assert shapes["count/light"][0] == spgemm.THREADS_SHORT
        assert shapes["fill/light"][1] <= spgemm.SLOTS_SHORT


@pytest.mark.cuda
@pytest.mark.parametrize("t", (4, 32))
def test_spgemm_at_the_bitmap_width_limit_on_card(cuda, t):
    """B as wide as the bitmap holds: the launcher shortens the fill's
    runs of A's tiles until its slots fit beside the bitmap, and a dense
    row of C takes many rounds."""
    n_cols = common.ROW_BITMAP_MAX_TILE_COLS * t
    rng = np.random.default_rng(3)
    k = 96
    ra, ca = np.nonzero(rng.random((40, k)) < 0.3)
    rb = rng.integers(0, k, 6000)
    cb = np.concatenate([rng.integers(0, n_cols, 5000),
                         n_cols - 1 - rng.integers(0, 64 * t, 1000)])
    a = P.coo_to_b2sr(ra, ca, 40, k, t, cuda)
    b = P.coo_to_b2sr(rb, cb, k, n_cols, t, cuda)
    assert b.n_tile_cols == common.ROW_BITMAP_MAX_TILE_COLS
    want = ref.spgemm_bbb(a, b)
    widest = int((want.tile_row_ptr[1:] - want.tile_row_ptr[:-1]).max())
    for heavy in (0, spgemm.NEVER):         # blocks of 32 warps, of one
        events = []
        got = spgemm._spgemm_bbb(a, b, None, False, heavy, events=events)
        _same_b2sr(got, want)
        threads, slots, run = [e[3] for e in events
                               if e[0].startswith("fill/")][0]
        assert slots >= 8
        if t == 32:                   # 32 transposed tiles leave no room
            assert run < 32
        assert widest > slots                  # several rounds
    with pytest.raises(ValueError, match="913408"):
        wide = P.coo_to_b2sr(rb, cb, k, n_cols + t, t, cuda)
        spgemm.spgemm_bbb(a, wide)


@pytest.mark.cuda
@pytest.mark.parametrize("t", (4, 8, 16, 32))
def test_spmm_bbb_cases_on_card(cuda, t):
    r, c = PG.rmat_graph(700, avg_degree=12, seed=t)
    n = 700
    m = P.coo_to_b2sr(r, c, n, n, t, cuda)
    cut = work_items(m, 3)
    for case in ("cut", "wide", "empty", "no_mask", "all_ones_keep",
                 "all_ones_complement"):
        s, f, mk, comp = _frontier_case(case, n, np.random.default_rng(t))
        pf = P.pack_frontier_matrix(torch.from_numpy(f).to(cuda), t, n)
        pm = None if mk is None else P.pack_frontier_matrix(
            torch.from_numpy(mk).to(cuda), t, n)
        want = sref.spmm_bbb(m, pf, pm, complement=comp)
        for items in (None, cut):
            before = spmm.spmm_bbb.launches
            got = spmm.spmm_bbb(m, pf, pm, complement=comp, items=items)
            assert spmm.spmm_bbb.launches == before + 1
            assert torch.equal(got, want), (t, case, items is None)
