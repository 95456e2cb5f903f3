"""PyTorch port vs the JAX reference: the popcount SpMM (``spmm_bbf``)
and the masked product reduction (``bmm_tc``) on directed graphs, and the
host-side helpers of the two kernels' designs.

The same numpy-seeded COO (a directed graph with self-loops, repeated
edges and a hub row), ``BitMatrix`` words and masks go through ``repro``
(Pallas in interpret mode) and ``repro_torch`` on the CPU, where the
wrappers run their plain versions. Every result is an integer: equal.
The helpers (``bmm.min_walk``, the items of ``bmm._work_items``) are held
against numpy counts. The tests marked ``cuda`` hold both kernels against
their plain versions on the card, with A, Bᵀ and the mask all different,
work items cut to a few tiles or set bits, a plan that moves every mask
tile and an A wider than the kernel's bitmap, and skip here.
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
    from repro.core.operands import BitMatrix as RBitMatrix
    from repro.kernels.bmm import ops as r_kops
except ImportError:                      # a card's machine without JAX
    jnp = None

from repro_torch import convert  # noqa: E402
from repro_torch.core import b2sr as P  # noqa: E402
from repro_torch.core.graphblas import GraphMatrix  # noqa: E402
from repro_torch.kernels import common, items as wi  # noqa: E402
from repro_torch.kernels.bmm import bmm, ref  # noqa: E402
from repro_torch.kernels.spmm import ref as sref, spmm  # noqa: E402

needs_reference = pytest.mark.skipif(
    jnp is None, reason="the JAX reference package needs jax")

N = 90                                    # not a multiple of 8, 16 or 32


@functools.lru_cache(maxsize=None)
def directed_coo(n: int = N, seed: int = 11):
    """A directed graph with self-loops, repeated edges and a hub row
    (vertex 1 points at every other vertex), made by numpy."""
    rng = np.random.default_rng(seed)
    r = rng.integers(0, n, 4 * n)
    c = rng.integers(0, n, 4 * n)
    loops = np.arange(0, n, 5)
    hub = np.arange(0, n, 2)
    rows = np.concatenate([r, r[: n // 2], loops, np.ones_like(hub)])
    cols = np.concatenate([c, c[: n // 2], loops, hub])
    return rows.astype(np.int64), cols.astype(np.int64)


@functools.lru_cache(maxsize=None)
def mask_coo(n: int = N, seed: int = 12):
    rng = np.random.default_rng(seed)
    return rng.integers(0, n, 6 * n), rng.integers(0, n, 6 * n)


def dense(rows, cols, n: int = N) -> np.ndarray:
    a = np.zeros((n, n), np.int64)
    a[rows, cols] = 1
    return a


def operands(t: int, device="cpu", n: int = N):
    """(A, Bᵀ = Aᵀ, mask) as port B2SRs: Σ mask ⊙ (A·A)."""
    r, c = directed_coo(n)
    mr, mc = mask_coo(n)
    return (P.coo_to_b2sr(r, c, n, n, t, device),
            P.coo_to_b2sr(c, r, n, n, t, device),
            P.coo_to_b2sr(mr, mc, n, n, t, device))


def masked_square(n: int = N) -> int:
    a = dense(*directed_coo(n), n)
    return int(((a @ a) * dense(*mask_coo(n), n)).sum())


def row_lengths(m) -> np.ndarray:
    return np.diff(m.tile_row_ptr.cpu().numpy()).astype(np.int64)


def moved_only(t: int, device="cpu", n: int = N):
    """(A, Bᵀ = Aᵀ, mask, Σ mask ⊙ (A·A)) with a mask whose every tile
    (I, J) has A's row I shorter than Bᵀ's row J, so that the plan moves
    every tile and its kept part is empty: the mask holds the non-zero
    entries of A·A in those tiles."""
    a, bt, _ = operands(t, device, n)
    adj = dense(*directed_coo(n), n)
    prod = adj @ adj
    tile = np.arange(n) // t
    short = row_lengths(a)[tile][:, None] < row_lengths(bt)[tile][None, :]
    mr, mc = np.nonzero((prod > 0) & short)
    mask = P.coo_to_b2sr(mr, mc, n, n, t, device)
    return a, bt, mask, int(prod[mr, mc].sum())


# -- host-side helpers against numpy counts -------------------------------------

@pytest.mark.parametrize("t", (4, 32))
def test_min_walk_matches_numpy_count(t):
    a, bt, mask = operands(t)
    a_len, bt_len = row_lengths(a), row_lengths(bt)
    want = 0
    ptr = mask.tile_row_ptr.numpy()
    cols = mask.tile_col_idx.numpy()
    for i in range(mask.n_tile_rows):
        for j in cols[ptr[i]:ptr[i + 1]]:
            want += min(a_len[i], bt_len[j])
    assert bmm.min_walk(a, bt, mask) == want > 0


@pytest.mark.parametrize("probes", (1, 40, bmm.ITEM_PROBES))
def test_tc_items_match_numpy_cut(probes):
    """Items: runs of a row's mask tiles whose probes (Bᵀ's row length
    plus one) reach max(probes, 4 · A's row length) at a run's start."""
    a, bt, mask = operands(8)
    a_len, bt_len = row_lengths(a), row_lengths(bt)
    ptr = mask.tile_row_ptr.numpy()
    cols = mask.tile_col_idx.numpy()
    rows_want, begin_want = [], []
    for i in range(mask.n_tile_rows):
        budget = max(probes, 4 * a_len[i])
        done, part = 0, None
        for k in range(ptr[i], ptr[i + 1]):
            if part != done // budget:
                part = done // budget
                rows_want.append(i)
                begin_want.append(k)
            done += bt_len[cols[k]] + 1
    item_row, item_begin = bmm._work_items(a, bt, mask, probes)
    assert item_row.dtype == item_begin.dtype == torch.int32
    assert item_row.tolist() == rows_want
    assert item_begin.tolist() == begin_want + [mask.n_tiles]


@pytest.mark.parametrize("t", (4, 16))
@pytest.mark.parametrize("shorter", (True, False))
def test_tc_plan_splits_by_the_shorter_row(t, shorter):
    """Each mask tile goes to the side of its shorter row: kept as it is,
    or transposed (tile (J, I), bits transposed) for the swapped launch;
    the plain sums over the parts add up to the whole."""
    a, bt, mask = operands(t)
    plan = bmm.tc_plan(a, bt, mask, 40, shorter)
    a_len, bt_len = row_lengths(a), row_lengths(bt)
    want = {}
    ptr, cols = mask.tile_row_ptr.numpy(), mask.tile_col_idx.numpy()
    words = mask.bit_tiles.numpy()
    for i in range(mask.n_tile_rows):
        for k in range(ptr[i], ptr[i + 1]):
            j = cols[k]
            swap = bool(shorter and a_len[i] < bt_len[j])
            want[swap, (j, i) if swap else (i, j)] = (
                dense_tile_t(words[k], t) if swap else words[k])
    got, total = {}, 0
    parts = [(False, plan.kept)] + ([(True, plan.moved)]
                                    if plan.moved is not None else [])
    for swapped, part in parts:
        assert part.moved == swapped
        rows = np.repeat(np.arange(part.n_tile_rows),
                         np.diff(part.tile_row_ptr.numpy()))
        tiles = words[part.idx.numpy()]
        if swapped:                      # the kernel reads them transposed
            tiles = np.stack([dense_tile_t(w, t) for w in tiles])
        for r, c, w in zip(rows, part.tile_col_idx.numpy(), tiles):
            got[swapped, (r, c)] = w
        m = P.B2SR(part.tile_row_ptr, part.tile_col_idx,
                   torch.from_numpy(tiles.reshape(-1, t)), t, part.n_rows,
                   (mask.n_rows if swapped else mask.n_cols), 0)
        total += int(ref.bmm_tc(bt, a, m) if swapped
                     else ref.bmm_tc(a, bt, m))
    assert got.keys() == want.keys()
    assert all(np.array_equal(got[k], want[k]) for k in want)
    assert total == masked_square()
    assert (plan.moved is not None) == (shorter and any(k[0] for k in want))
    # every tile of a part in one item, an item's tiles in its row
    for (swapped, part), items in zip(parts, (plan.kept_items,
                                              plan.moved_items)):
        item_row, bounds = (v.numpy() for v in items)
        rows = np.repeat(np.arange(part.n_tile_rows),
                         np.diff(part.tile_row_ptr.numpy()))
        assert bounds[0] == 0 and bounds[-1] == part.n_tiles
        for row, b, e in zip(item_row, bounds[:-1], bounds[1:]):
            assert b < e and (rows[b:e] == row).all()


def dense_tile_t(words: np.ndarray, t: int) -> np.ndarray:
    """The bit transpose of one tile's t words, by numpy."""
    bits = (words[:, None].astype(np.int64) >> np.arange(t)) & 1
    return (bits.T << np.arange(t)).sum(1).astype(np.int64).astype(
        np.uint32).view(np.int32)


def test_private_wrapper_runs_the_plain_version_on_cpu():
    a, bt, mask = operands(4)
    before = bmm.bmm_tc.launches
    for plan in (None, bmm.tc_plan(a, bt, mask)):
        got = bmm._bmm_tc(a, bt, mask, False, True, plan)
        assert got.dtype == torch.int64 and int(got) == masked_square()
    assert bmm.bmm_tc.launches == before
    wide = P.coo_to_b2sr([0], [0], 4, 32 * common.ROW_BITMAP_MAX_TILE_COLS,
                         32, "cpu")
    # the CPU path takes any width; the width check is the kernel's
    assert int(bmm.bmm_tc(wide, wide, P.coo_to_b2sr([0], [0], 4, 4, 32,
                                                    "cpu"))) == 1


@pytest.mark.parametrize("t,n", ((4, N), (32, 700)))
def test_tc_plan_moves_every_tile_of_a_short_row_mask(t, n):
    """A mask whose A rows are all shorter than their Bᵀ rows: the kept
    part is empty, and the moved part alone holds the whole sum."""
    a, bt, mask, want = moved_only(t, n=n)
    plan = bmm.tc_plan(a, bt, mask)
    assert plan.kept.n_tiles == 0 and plan.kept_items[0].numel() == 0
    assert plan.moved.n_tiles == mask.n_tiles > 0 and want > 0
    part = plan.moved
    tiles = np.stack([dense_tile_t(w, t)
                      for w in mask.bit_tiles.numpy()[part.idx.numpy()]])
    m = P.B2SR(part.tile_row_ptr, part.tile_col_idx,
               torch.from_numpy(tiles.reshape(-1, t)), t, part.n_rows,
               mask.n_rows, 0)
    assert int(ref.bmm_tc(bt, a, m)) == int(bmm.bmm_tc(a, bt, mask)) == want


# -- against the JAX reference -------------------------------------------------------

@needs_reference
@pytest.mark.parametrize("t", (4, 32))
def test_bmm_tc_directed_matches_reference(t):
    r, c = directed_coo()
    mr, mc = mask_coo()
    want = r_kops.bmm_bin_bin_sum_masked(
        R.to_ell(R.coo_to_b2sr(r, c, N, N, t)),
        R.to_ell(R.coo_to_b2sr(r, c, N, N, t)),          # B = A
        R.to_ell(R.coo_to_b2sr(mr, mc, N, N, t)), interpret=True)
    got = bmm.bmm_tc(*operands(t))
    assert int(got) == int(want) == masked_square()


@needs_reference
@pytest.mark.parametrize("t", (8, 16))
def test_spmm_bbf_directed_matches_reference(t):
    d = 7
    r, c = directed_coo()
    x = np.random.default_rng(t).random((N, d)) < 0.4
    rb = RBitMatrix.pack(jnp.asarray(x.astype(np.float32)), t)
    pb = convert.bitmatrix_from_reference(np.asarray(rb.words), N, t,
                                          device="cpu")
    rg = RGraph.from_coo(r, c, N, N, t).with_backend("b2sr_pallas")
    pg = GraphMatrix.from_coo(r, c, N, N, t, device="cpu",
                              backend="b2sr_cuda")
    want = np.asarray(rg.mxm(rb, out_dtype=jnp.int32))
    got = pg.mxm(pb, out_dtype=torch.int32)
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(got.numpy(), dense(r, c) @ x.astype(np.int64))


# -- on the card ---------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("t", (4, 8, 16, 32))
def test_spmm_bbf_matches_plain_on_card(cuda, t):
    n = 700
    r, c = directed_coo(n, seed=t)
    m = P.coo_to_b2sr(r, c, n, n, t, cuda)
    cuts = (None, wi.work_items(m, 3), wi.work_items(m, 5, by_bits=True))
    lens = m.tile_row_ptr[1:] - m.tile_row_ptr[:-1]
    assert int(lens.max()) == m.n_tile_cols   # the hub row, cut by both cuts
    rng = np.random.default_rng(t)
    for d in (1, 7, 16, 33, 130):
        xw = P.pack_bitmatrix(torch.from_numpy(rng.random((n, d)) < 0.4).to(
            cuda), t)
        want = sref.spmm_bbf(m, xw, torch.int32)
        for items in cuts:
            before = spmm.spmm_bbf.launches
            got = spmm.spmm_bbf(m, xw, torch.int32, items=items)
            assert spmm.spmm_bbf.launches == before + 1
            assert torch.equal(got, want), (t, d)


@pytest.mark.cuda
@pytest.mark.parametrize("t", (4, 8, 16, 32))
def test_bmm_tc_distinct_operands_on_card(cuda, t):
    n = 700
    a, bt, mask = operands(t, cuda, n)
    want = masked_square(n)
    assert int(ref.bmm_tc(a, bt, mask)) == want
    total, work = bmm.bmm_tc(a, bt, mask, with_work=True)
    assert int(total) == want and int(work) > 0
    queued = {}      # entries queued, by split: a swapped part queues
    for probes, shorter in ((64, True), (bmm.ITEM_PROBES, True), (1, False),
                            (64, False)):
        plan = bmm.tc_plan(a, bt, mask, probes, shorter)
        before = bmm.bmm_tc.launches
        got, w, q = bmm._bmm_tc(a, bt, mask, True, True, plan)
        assert int(got) == want and int(w) == int(work), (probes, shorter)
        assert queued.setdefault(shorter, int(q)) == int(q) > 0
        parts = [p for p in (plan.kept, plan.moved)
                 if p is not None and p.n_tiles]
        assert bmm.bmm_tc.launches == before + len(parts)
    # the probes alone: the same work, nothing queued, no count
    got, w, q = bmm._bmm_tc(a, bt, mask, True, False, None)
    assert int(got) == 0 and int(w) == int(work) and int(q) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("t", (4, 8, 16, 32))
def test_bmm_tc_every_tile_moved_on_card(cuda, t):
    """A plan with an empty kept part: the moved launch alone runs, and
    fills the occupancy words it reads."""
    a, bt, mask, want = moved_only(t, cuda, 700)
    plan = bmm.tc_plan(a, bt, mask)
    assert plan.kept.n_tiles == 0 and plan.moved.n_tiles == mask.n_tiles
    assert int(ref.bmm_tc(a, bt, mask)) == want > 0
    before = bmm.bmm_tc.launches
    for p in (None, plan):
        assert int(bmm.bmm_tc(a, bt, mask, plan=p)) == want
    assert bmm.bmm_tc.launches == before + 2


@pytest.mark.cuda
def test_bmm_tc_wider_than_its_bitmap_raises_on_card(cuda):
    wide = P.coo_to_b2sr([0], [0], 4, 32 * common.ROW_BITMAP_MAX_TILE_COLS,
                         32, cuda)
    mask = P.coo_to_b2sr([0], [0], 4, 4, 32, cuda)
    with pytest.raises(RuntimeError, match="tile columns"):
        bmm.bmm_tc(wide, wide, mask)
