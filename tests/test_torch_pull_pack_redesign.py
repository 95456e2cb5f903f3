"""PyTorch port vs the JAX reference: the pull step over work items and
the streaming ``pack_dense``.

The same numpy-seeded COO, frontiers, masks and dense entries go through
``repro`` and ``repro_torch`` on the CPU (``b2sr_cuda`` on a CPU graph
runs the kernels' plain versions; the reference's Pallas rows run in
interpret mode). Every comparison is bit for bit: both steps produce
packed words. The tests marked ``cuda`` hold both kernels against their
plain versions on the card, with cuts that split every row, and skip
here.
"""

from __future__ import annotations

import functools
import itertools
from unittest import mock

import numpy as np
import pytest

torch = pytest.importorskip("torch")

try:
    import jax.numpy as jnp
    from repro.core.descriptor import Descriptor as RDescriptor
    from repro.core.graphblas import GraphMatrix as RGraph
    from repro.core.operands import BitVector as RBitVector
    from repro.kernels.bitpack import ops as rbitpack
except ImportError:                      # a card's machine without JAX
    jnp = None

from repro_torch.core.descriptor import Descriptor  # noqa: E402
from repro_torch.core.graphblas import GraphMatrix  # noqa: E402
from repro_torch.core.operands import BitVector  # noqa: E402
from repro_torch.core.words import to_numpy_u32  # noqa: E402
from repro_torch.kernels import items as wi  # noqa: E402
from repro_torch.kernels.bitpack import bitpack, ops as pops  # noqa: E402
from repro_torch.kernels.bitpack import ref as pref  # noqa: E402
from repro_torch.kernels.bmv import bmv, ops as bmv_ops, ref  # noqa: E402

needs_reference = pytest.mark.skipif(
    jnp is None, reason="the JAX reference package needs jax")

N = 150                                  # not a multiple of 8, 16 or 32
FRONTIERS = ("empty", "sparse", "ones")
DTYPES = (torch.bool, torch.uint8, torch.int8, torch.int32, torch.float32)
WIDTHS = (1, 15, 17, 33, 100)
PACK_ROWS = 70


@functools.lru_cache(maxsize=None)
def directed_coo():
    """A directed graph with self-loops, repeated edges and a hub tile-row
    (vertices 0 and 1 point at every other vertex), made by numpy."""
    rng = np.random.default_rng(20)
    r = rng.integers(0, N, 500)
    c = rng.integers(0, N, 500)
    loops = np.arange(0, N, 5)
    hub = np.arange(0, N, 2)
    rows = np.concatenate([r, loops, r[:80], np.zeros_like(hub),
                           np.ones_like(hub)])
    cols = np.concatenate([c, loops, c[:80], hub, hub + 1])
    return rows.astype(np.int64), cols.astype(np.int64) % N


def port_graph(t: int, device="cpu"):
    r, c = directed_coo()
    return GraphMatrix.from_coo(r, c, N, N, t, device=device,
                                backend="b2sr_cuda")


@functools.lru_cache(maxsize=None)
def ref_graph(t: int, backend: str):
    r, c = directed_coo()
    return RGraph.from_coo(r, c, N, N, t).with_backend(backend)


def frontier(kind: str, seed: int) -> np.ndarray:
    if kind == "empty":
        return np.zeros(N, dtype=bool)
    if kind == "ones":
        return np.ones(N, dtype=bool)
    return np.random.default_rng(seed).random(N) < 0.05


# -- the pull row against the reference's ------------------------------------------

@needs_reference
@pytest.mark.parametrize("t", (4, 8, 16, 32))
@pytest.mark.parametrize("complement", (False, True))
@pytest.mark.parametrize("front", FRONTIERS)
def test_pull_row_matches_reference(t, complement, front):
    xv = frontier(front, t)
    mv = np.random.default_rng(t + 7).random(N) < 0.5
    rdesc = RDescriptor(mask=RBitVector.pack(jnp.asarray(mv), t, N),
                        complement=complement, direction="pull")
    pdesc = Descriptor(mask=BitVector.pack(torch.from_numpy(mv), t, N),
                       complement=complement, direction="pull")
    g = port_graph(t)
    wi.items_for(g, bmv.BBF_ITEM_WORK)       # the cut the row keeps
    got = g.mxv(BitVector.pack(torch.from_numpy(xv), t, N), desc=pdesc)
    assert isinstance(got, BitVector) and got.n == N
    for backend in ("b2sr", "b2sr_pallas"):
        want = ref_graph(t, backend).mxv(
            RBitVector.pack(jnp.asarray(xv), t, N), desc=rdesc)
        assert np.array_equal(np.asarray(want.words),
                              to_numpy_u32(got.words)), backend


@pytest.mark.parametrize("complement", (False, True))
def test_pull_and_push_rows_pass_the_same_kept_items(complement):
    g = port_graph(8)
    bits = np.random.default_rng(3).random(N) < 0.3
    x = BitVector.pack(torch.from_numpy(bits), 8)
    mask = BitVector.pack(torch.from_numpy(~bits), 8)
    seen = {}

    def spy(name, fn):
        def wrapped(*args, **kw):
            seen[name] = kw.get("items")
            seen[f"{name}_lanes"] = kw.get("lanes")
            return fn(*args, **kw)
        return wrapped

    with mock.patch.object(bmv_ops, "bmv_bbb_pull",
                           spy("pull", bmv.bmv_bbb_pull)), \
            mock.patch.object(bmv_ops, "bmv_bbb_push",
                              spy("push", bmv.bmv_bbb_push)):
        pulled = g.mxv(x, desc=Descriptor(mask=mask, complement=complement,
                                          direction="pull"))
        pushed = g.mxv(x, desc=Descriptor(mask=mask, complement=complement))
    kept = wi.items_for(g, bmv.BBF_ITEM_WORK)
    assert seen["pull"] is kept and seen["push"] is kept
    assert seen["pull_lanes"] is wi.lanes_for(g)
    assert torch.equal(pulled.words, pushed.words)


@pytest.mark.parametrize("t", (4, 8, 16, 32))
def test_row_lanes_match_numpy(t):
    r, c = directed_coo()
    m = port_graph(t).b2sr
    want = np.zeros(-(-N // t), dtype=np.uint64)
    for i in np.unique(r):                 # lane i % t of tile-row i // t
        want[i // t] |= np.uint64(1) << np.uint64(i % t)
    got = wi.row_lanes(m.tile_row_ptr, m.bit_tiles)
    assert got.dtype == torch.int32 and got.shape == (m.n_tile_rows,)
    assert np.array_equal(to_numpy_u32(got), want.astype(np.uint32))


def test_cpu_pull_counts_no_launch_whatever_the_items():
    m = port_graph(4).b2sr
    rng = np.random.default_rng(5)
    x = BitVector.pack(torch.from_numpy(rng.random(N) < 0.2), 4).words
    mask = BitVector.pack(torch.from_numpy(rng.random(N) < 0.5), 4).words
    args = (m.tile_row_ptr, m.tile_col_idx, m.bit_tiles, x, mask)
    before = (bmv.bmv_bbb_pull.launches, bmv.bmv_bbb_push.launches)
    for items in (None, wi.work_items(m, 1), wi.work_items(m, 3)):
        got = bmv.bmv_bbb_pull(*args, t=4, items=items)
        assert torch.equal(got, ref.bmv_bbb_pull(*args, t=4))
    assert (bmv.bmv_bbb_pull.launches, bmv.bmv_bbb_push.launches) == before
    with pytest.raises(ValueError, match="mask"):
        bmv.bmv_bbb_pull(*args[:4], None, t=4)


# -- the plain pack_dense against the reference's ------------------------------------

def dense_entries(dtype, n: int, m: int, seed: int) -> np.ndarray:
    """0/1-pattern entries of ``dtype`` (as numpy): float32 with -0.0
    among its zeros and other non-zero values, int8 negative ones."""
    rng = np.random.default_rng(seed)
    keep = rng.random((n, m)) < 0.3
    v = rng.integers(-3, 4, (n, m))
    v[v == 0] = 2
    if dtype == torch.bool:
        return keep
    if dtype == torch.uint8:
        return np.where(keep, np.abs(v), 0).astype(np.uint8)
    if dtype == torch.int8:
        return np.where(keep, v, 0).astype(np.int8)
    if dtype == torch.int32:
        return np.where(keep, v * 1000, 0).astype(np.int32)
    x = np.where(keep, v * 0.25, 0.0).astype(np.float32)
    x[~keep & (rng.random((n, m)) < 0.5)] = -0.0
    return x


def ref_pack(x: np.ndarray, t: int, col_major: bool) -> np.ndarray:
    return np.asarray(rbitpack.pack_dense(jnp.asarray(x), t, col_major,
                                          interpret=True))


@needs_reference
@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: str(d)[6:])
@pytest.mark.parametrize("col_major", (False, True))
def test_plain_pack_dense_matches_reference(dtype, col_major):
    for m, t in zip(WIDTHS, (4, 8, 16, 32, 8)):
        x = dense_entries(dtype, PACK_ROWS, m, m)
        got = pops.pack_dense(torch.from_numpy(x), t, col_major)
        assert got.shape == (-(-PACK_ROWS // t), -(-m // t), t)
        assert np.array_equal(to_numpy_u32(got), ref_pack(x, t, col_major)), \
            (m, t)


@needs_reference
@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: str(d)[6:])
def test_plain_pack_dense_of_an_offset_view_matches_reference(dtype):
    n, m, t = 40, 33, 8
    flat = torch.from_numpy(dense_entries(dtype, 1, n * m + 5, 9)).flatten()
    view = flat[5:].view(n, m)
    assert view.is_contiguous() and view.storage_offset() == 5
    want = ref_pack(view.numpy(), t, False)
    assert np.array_equal(to_numpy_u32(pops.pack_dense(view, t)), want)
    assert np.array_equal(to_numpy_u32(pops.pack_dense(view, t, True)),
                          ref_pack(view.numpy(), t, True))


def test_cpu_pack_dense_counts_no_launch():
    x = torch.from_numpy(dense_entries(torch.uint8, PACK_ROWS, 100, 1))
    before = bitpack.pack_dense.launches
    assert torch.equal(bitpack.pack_dense(x, 32, True),
                       pref.pack_dense(x, 32, True))
    assert bitpack.pack_dense.launches == before


# -- on the card ------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    return torch.device("cuda")


HUB_TILES = 4096


def _hub_graph(t: int, dev):
    """Random edges plus a hub tile-row of at least HUB_TILES tiles
    (vertex 0 points at every 32nd vertex, one tile each at any t)."""
    n = 32 * HUB_TILES
    rng = np.random.default_rng(t)
    r = rng.integers(0, n, 20000)
    c = rng.integers(0, n, 20000)
    hub = np.arange(0, n, 32)
    return GraphMatrix.from_coo(np.concatenate([r, np.zeros_like(hub)]),
                                np.concatenate([c, hub]), n, n, t,
                                device=dev, backend="b2sr_cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("t", (4, 8, 16, 32))
def test_pull_items_match_plain_on_card(cuda, t):
    g = _hub_graph(t, cuda)
    m = g.b2sr
    ptr = m.tile_row_ptr
    assert int(ptr[1] - ptr[0]) >= HUB_TILES
    args = (m.tile_row_ptr, m.tile_col_idx, m.bit_tiles)
    rng = np.random.default_rng(t)
    ones = torch.full((g.b2sr.n_tile_rows,), -1, dtype=torch.int32,
                      device=cuda)
    zeros = torch.zeros_like(ones)
    cuts = (None, wi.work_items(m, 1), wi.work_items(m, 3))
    # the lanes computed by the wrapper, and every lane (a superset)
    lanes = (None, ones)
    for dens in (0.0, 0.001, 0.1, 0.6, 1.0):
        x = g.pack(torch.as_tensor(rng.random(g.n_cols) < dens, device=cuda))
        mask = g.pack_rows(torch.as_tensor(rng.random(g.n_rows) < 0.5,
                                           device=cuda))
        # a random mask kept and complemented; every lane allowed; none
        for mk, comp in ((mask, True), (mask, False), (zeros, True),
                         (ones, False), (ones, True)):
            want = ref.bmv_bbb_pull(*args, x, mk, t=t, complement=comp)
            for items, ln in itertools.product(cuts, lanes):
                got = bmv.bmv_bbb_pull(*args, x, mk, t=t, complement=comp,
                                       items=items, lanes=ln)
                again = bmv.bmv_bbb_pull(*args, x, mk, t=t,
                                         complement=comp, items=items,
                                         lanes=ln)
                assert torch.equal(got, want), (dens, comp, items is None,
                                                ln is None)
                assert torch.equal(again, got)
            push = bmv.bmv_bbb_push(*args, x, mk, t=t, complement=comp)
            assert torch.equal(push, want)


def _card_pack_inputs(dev):
    """(label, entries) on the card: each type at WIDTHS and at widths
    that take the vector path, and contiguous views with an offset."""
    for dtype in DTYPES:
        for m in (*WIDTHS, 1024, 1040):
            x = torch.from_numpy(dense_entries(dtype, PACK_ROWS, m, m))
            yield f"{dtype} {m}", x.to(dev)
        flat = torch.from_numpy(dense_entries(dtype, 1, PACK_ROWS * 1040
                                              + 64, 3)).flatten().to(dev)
        for off in (5, 16 // flat.element_size()):
            yield (f"{dtype} offset {off}",
                   flat[off:off + PACK_ROWS * 1040].view(PACK_ROWS, 1040))


@pytest.mark.cuda
@pytest.mark.parametrize("t", (4, 8, 16, 32))
def test_pack_dense_matches_plain_on_card(cuda, t):
    for label, x in _card_pack_inputs(cuda):
        for col_major in (False, True):
            got = bitpack.pack_dense(x, t, col_major)
            assert torch.equal(got, pref.pack_dense(x, t, col_major)), \
                (label, col_major)
