"""PyTorch port vs the JAX reference: ``GraphMatrix.mxm`` over graph operands.

The same seeded COO goes through ``repro`` and ``repro_torch`` (on the
CPU; ``b2sr_cuda`` on a CPU graph runs the kernels' plain versions).
Each port backend is held against its reference twin (``b2sr`` against
``b2sr``, ``b2sr_cuda`` against ``b2sr_pallas`` in interpret mode, ``csr``
against ``csr``). Boolean products must equal the reference's B2SR bit
for bit (``tile_row_ptr``, ``tile_col_idx``, ``bit_tiles``, ``nnz``),
counts exactly: no tolerance applies anywhere. The tests marked ``cuda``
hold the SpGEMM kernel against its plain version on the card and skip
here.
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
    from repro.core.semiring import SEMIRINGS as R_SEMIRINGS
except ImportError:                      # a card's machine without JAX
    jnp = None

from repro_torch.core import b2sr as P  # noqa: E402
from repro_torch.core import csr as csr_mod  # noqa: E402
from repro_torch.core import dispatch  # noqa: E402
from repro_torch.core.descriptor import Descriptor  # noqa: E402
from repro_torch.core.graphblas import GraphMatrix  # noqa: E402
from repro_torch.core.operands import BitMatrix, BitVector  # noqa: E402
from repro_torch.core.semiring import ARITHMETIC, SEMIRINGS  # noqa: E402
from repro_torch.core.words import from_numpy_u32, to_numpy_u32  # noqa: E402
from repro_torch.data import graphs as PG  # noqa: E402
from repro_torch.kernels import common  # noqa: E402
from repro_torch.kernels.spgemm import ref, spgemm  # noqa: E402

needs_reference = pytest.mark.skipif(
    jnp is None, reason="the JAX reference package needs jax")

N = 44                                    # not a multiple of 8, 16 or 32
TILE_DIMS = (4, 8, 16, 32)
#: (port backend, buckets, reference backend); ``b2sr_cuda`` and ``csr``
#: run one function for both bucket flags
BACKEND_CASES = (("b2sr", False, "b2sr"), ("b2sr", True, "b2sr"),
                 ("b2sr_cuda", False, "b2sr_pallas"), ("csr", False, "csr"))
MASKS = ("none", "keep", "complement")


@functools.lru_cache(maxsize=None)
def coo(name: str):
    if name == "a":
        return PG.rmat_graph(N, avg_degree=5, seed=3)
    return PG.dot_graph(N, density=0.12, seed=4)        # the mask


@functools.lru_cache(maxsize=None)
def ref_graph(name: str, t: int, backend: str = "b2sr",
              buckets: bool = True):
    r, c = coo(name)
    return RGraph.from_coo(r, c, N, N, t).with_backend(backend).with_buckets(
        buckets)


@functools.lru_cache(maxsize=None)
def port_graph(name: str, t: int, backend: str = "b2sr",
               buckets: bool = True):
    r, c = coo(name)
    return GraphMatrix.from_coo(r, c, N, N, t, device="cpu",
                                backend=backend).with_buckets(buckets)


def ref_arrays(g):
    """The reference result's B2SR arrays, from its ELL view."""
    ell = g.ell
    col = np.asarray(ell.tile_col_idx)
    valid = col >= 0
    ptr = np.concatenate([[0], np.cumsum(np.asarray(ell.row_n_tiles))])
    return (ptr.astype(np.int32), col[valid],
            np.asarray(ell.bit_tiles)[valid], g.nnz)


def port_arrays(m):
    return (m.tile_row_ptr.numpy(), m.tile_col_idx.numpy(),
            to_numpy_u32(m.bit_tiles), m.nnz)


def assert_same(want, got):
    for w, g in zip(want, got):
        assert np.array_equal(np.asarray(w), np.asarray(g))


def assert_sorted_rows(m):
    """Every tile-row's column indices strictly increase (the kernels'
    binary searches and ranks rely on it)."""
    ptr, col = m.tile_row_ptr.long(), m.tile_col_idx.long()
    if col.numel() < 2:
        return
    step = col[1:] - col[:-1]
    same_row = P.tile_rows(m)[1:] == P.tile_rows(m)[:-1]
    assert bool((step[same_row] > 0).all())
    assert int(ptr[-1]) == col.numel()


# -- the boolean rows ---------------------------------------------------------

@needs_reference
@pytest.mark.parametrize("mask", MASKS)
@pytest.mark.parametrize("backend,buckets,ref_backend", BACKEND_CASES)
@pytest.mark.parametrize("t", TILE_DIMS)
def test_mxm_bool_matches_reference(t, backend, buckets, ref_backend, mask):
    rg = ref_graph("a", t, ref_backend, buckets)
    pg = port_graph("a", t, backend, buckets)
    kw, pkw = {}, {}
    if mask != "none":
        kw = dict(mask=ref_graph("m", t), complement=mask == "complement")
        pkw = dict(mask=port_graph("m", t), complement=mask == "complement")
    want = rg.mxm(rg, **kw)
    got = pg.mxm(pg, **pkw)
    assert isinstance(got, GraphMatrix) and got.backend == backend
    assert (got.n_rows, got.n_cols, got.tile_dim) == (N, N, t)
    assert_same(ref_arrays(want), port_arrays(got.b2sr))
    assert_sorted_rows(got.b2sr)


def _rect_coo(rows: int, cols: int, density: float, seed: int):
    rng = np.random.default_rng(seed)
    r, c = np.nonzero(rng.random((rows, cols)) < density)
    return r, c


@needs_reference
@pytest.mark.parametrize("backend,ref_backend", (
    ("b2sr", "b2sr"), ("b2sr_cuda", "b2sr_pallas"), ("csr", "csr")))
@pytest.mark.parametrize("case", ("no_replace", "no_replace_comp",
                                  "transpose_a", "rectangular", "empty",
                                  "zero_tile", "default_other"))
def test_mxm_cases_match_reference(case, backend, ref_backend):
    t = 8
    rg = ref_graph("a", t, ref_backend)
    pg = port_graph("a", t, backend)
    if case.startswith("no_replace"):
        comp = case == "no_replace_comp"
        ro, po = ref_graph("m", t), port_graph("m", t)
        rm = RGraph.from_coo(*coo("a")[::-1], N, N, t)
        pm = GraphMatrix.from_coo(*coo("a")[::-1], N, N, t, device="cpu")
        want = rg.mxm(rg, desc=RDescriptor(mask=rm, complement=comp,
                                           replace=False), out=ro)
        got = pg.mxm(pg, desc=Descriptor(mask=pm, complement=comp,
                                         replace=False), out=po)
    elif case == "transpose_a":
        rb, pb = ref_graph("m", t, ref_backend), port_graph("m", t, backend)
        want = rg.mxm(rb, desc=RDescriptor(transpose_a=True))
        got = pg.mxm(pb, desc=Descriptor(transpose_a=True))
    elif case == "default_other":
        want, got = rg.mxm(), pg.mxm(with_transpose=False)
        assert got.bwd is None
    else:
        if case == "rectangular":
            shapes = ((37, 21, 0.15, 1), (21, 50, 0.15, 2))
        elif case == "empty":        # A's columns miss every row of B
            shapes = ((20, 30, 0.0, 1), (30, 20, 0.3, 2))
        else:                        # tile products that come out zero
            shapes = ((16, 16, None, 0), (16, 16, None, 1))
        mats = []
        for i, (nr, nc, dens, seed) in enumerate(shapes):
            if dens is None:         # A(0, 0) hits only column 1, B only row 0
                r, c = (np.array([0, 9]), np.array([1, 9])) if i == 0 else \
                    (np.array([0, 9]), np.array([3, 12]))
            else:
                r, c = _rect_coo(nr, nc, dens, seed)
            mats.append((r, c, nr, nc))
        (ra, ca, na, ka), (rb_, cb, kb, nb) = mats
        want = RGraph.from_coo(ra, ca, na, ka, t).with_backend(
            ref_backend).mxm(RGraph.from_coo(rb_, cb, kb, nb, t))
        got = GraphMatrix.from_coo(ra, ca, na, ka, t, device="cpu",
                                   backend=backend).mxm(
            GraphMatrix.from_coo(rb_, cb, kb, nb, t, device="cpu"))
        if case == "empty":
            assert got.nnz == 0 and got.b2sr.n_tiles == 0
        if case == "zero_tile":      # (0,0) pairs up but ORs nothing in
            assert got.b2sr.n_tiles == 1 and got.nnz == 1
    assert_same(ref_arrays(want), port_arrays(got.b2sr))
    assert_sorted_rows(got.b2sr)


# -- the count rows -----------------------------------------------------------

@needs_reference
@pytest.mark.parametrize("mask", MASKS)
@pytest.mark.parametrize("backend,buckets,ref_backend", BACKEND_CASES)
def test_mxm_counts_match_reference(backend, buckets, ref_backend, mask):
    t = 8
    rg = ref_graph("a", t, ref_backend, buckets)
    pg = port_graph("a", t, backend, buckets)
    kw, pkw = {}, {}
    if mask != "none":
        kw = dict(mask=ref_graph("m", t), complement=mask == "complement")
        pkw = dict(mask=port_graph("m", t), complement=mask == "complement")
    want = np.asarray(rg.mxm(rg, R_SEMIRINGS["arithmetic"], **kw))
    got = pg.mxm(pg, ARITHMETIC, **pkw)
    assert str(got.dtype).split(".")[-1] == str(want.dtype)
    assert np.array_equal(want, got.numpy())


def test_mxm_counts_no_replace_merges_outside_the_mask():
    """Count rows with ``replace=False``: masked-out entries come from
    ``out`` (the reference's merge does not do this; ROADMAP Queue 3)."""
    t = 8
    pg, pm = port_graph("a", t), port_graph("m", t)
    out = torch.full((N, N), -1, dtype=torch.int32)
    dense = np.zeros((N, N), np.int32)
    dense[coo("a")] = 1
    dm = np.zeros((N, N), bool)
    dm[coo("m")] = True
    for comp in (False, True):
        got = pg.mxm(pg, ARITHMETIC, Descriptor(mask=pm, complement=comp,
                                                replace=False), out=out)
        keep = ~dm if comp else dm
        assert np.array_equal(got.numpy(), np.where(keep, dense @ dense, -1))


# -- the registry and the generic layer ---------------------------------------

@needs_reference
def test_registry_has_every_reference_graph_row():
    from repro.core import dispatch as r_dispatch
    backend = {"b2sr": "b2sr", "b2sr_pallas": "b2sr_cuda", "csr": "csr"}
    want = {k[:3] + (backend[k[3]],) + k[4:]
            for k in r_dispatch.registered_keys(load_all=True)
            if (k[0], k[1]) in (("mxm", "graph"), ("mxm_sum", "tri"))}
    got = {k for k in dispatch.registered_keys(load_all=True)
           if k[1] in ("graph", "tri")}
    # 3 backends unsharded, the 2 bit backends sharded
    assert len(want) == 3 * (8 + 2) + 2 * (8 + 2) and want == got


@needs_reference
@pytest.mark.parametrize("rhs", ("bitvec", "frontier", "graph", "dense",
                                 "bitmat"))
def test_semiring_rules_match_reference(rhs):
    from repro.core import dispatch as r_dispatch
    for name in SEMIRINGS:
        assert (dispatch.out_kind_for(SEMIRINGS[name], rhs)
                == r_dispatch.out_kind_for(R_SEMIRINGS[name], rhs))
        for op in ("mxv", "mxm", "mxv_pull", "mxm_pull"):
            try:
                r_dispatch.check_semiring(op, rhs, R_SEMIRINGS[name])
            except NotImplementedError:
                with pytest.raises(NotImplementedError):
                    dispatch.check_semiring(op, rhs, SEMIRINGS[name])
            else:
                dispatch.check_semiring(op, rhs, SEMIRINGS[name])


def test_mxm_rejects_what_the_reference_rejects():
    g = port_graph("a", 8)
    with pytest.raises(TypeError, match="BitVector"):
        g.mxm(BitVector.pack(torch.ones(N), 8, N))
    # a BitMatrix operand: the arithmetic semiring only, and the matrix's
    # tile dim, as in the reference
    bitmat = BitMatrix.pack(torch.ones(N, 3), 8)
    with pytest.raises(NotImplementedError, match="arithmetic"):
        g.mxm(bitmat, SEMIRINGS["boolean"])
    with pytest.raises(ValueError, match="tile_dim"):
        g.mxm(BitMatrix.pack(torch.ones(N, 3), 4))
    with pytest.raises(NotImplementedError, match="boolean"):
        g.mxm(g, SEMIRINGS["min_plus"])
    with pytest.raises(TypeError, match="structural"):
        g.mxm(g, mask=BitVector.pack(torch.ones(N), 8, N))
    with pytest.raises(ValueError, match="pull"):
        g.mxm(g, desc=Descriptor(mask=g, complement=True, direction="pull"))
    with pytest.raises(ValueError, match="replace=False"):
        g.mxm(g, desc=Descriptor(mask=g, replace=False))
    other = GraphMatrix.from_coo([0], [0], N + 1, N, 8, device="cpu")
    with pytest.raises(ValueError, match="inner-dim"):
        g.mxm(other)
    with pytest.raises(ValueError, match="tile_dim"):
        g.mxm(port_graph("a", 16))
    with pytest.raises(ValueError, match="tile_dim"):
        g.mxm(g, mask=port_graph("m", 16))
    # csr skips the tile-dim checks, as the reference's does
    assert g.with_backend("csr").mxm(port_graph("a", 16)).tile_dim == 8


@needs_reference
@pytest.mark.parametrize("t", (8, 32))
def test_grid_helpers_match_reference(t):
    rg, pg = ref_graph("a", t), port_graph("a", t)
    rgrid = np.asarray(R.ell_to_packed_grid(rg.ell))
    assert np.array_equal(rgrid, to_numpy_u32(P.ell_to_packed_grid(pg.ell)))
    assert np.array_equal(rgrid, to_numpy_u32(P.b2sr_to_packed_grid(pg.b2sr)))
    m = P.packed_grid_to_b2sr(from_numpy_u32(rgrid, "cpu"), N, N)
    rm = R.packed_grid_to_b2sr(rgrid, N, N)
    assert_same((np.asarray(rm.tile_row_ptr), np.asarray(rm.tile_col_idx),
                 np.asarray(rm.bit_tiles), rm.nnz), port_arrays(m))
    words = np.asarray(rg.ell.bit_tiles)
    assert np.array_equal(np.asarray(R.bit_transpose_words(jnp.asarray(
        words), t)), to_numpy_u32(P.bit_transpose_words(
            from_numpy_u32(words, "cpu"), t)))
    assert np.array_equal(
        np.asarray(R.or_reduce_words(jnp.asarray(words), (1, 2))),
        to_numpy_u32(P.or_reduce_words(from_numpy_u32(words, "cpu"),
                                       (1, 2))))


def test_from_b2sr_wraps_without_repacking():
    pg = port_graph("a", 8)
    g = GraphMatrix.from_b2sr(pg.b2sr, backend="csr")
    assert g.b2sr is pg.b2sr and g.backend == "csr"
    for mine, theirs in ((g.csr, pg.csr), (g.transposed().csr,
                                           pg.transposed().csr)):
        assert torch.equal(mine.row_ptr, theirs.row_ptr)
        assert torch.equal(mine.col_idx, theirs.col_idx)
    assert torch.equal(g.transposed().b2sr.bit_tiles,
                       pg.transposed().b2sr.bit_tiles)
    assert_sorted_rows(g.transposed().b2sr)


# -- the plain SpGEMM against the reference's Pallas kernel -------------------

@needs_reference
@pytest.mark.parametrize("mask", MASKS)
@pytest.mark.parametrize("t", (8, 32))
def test_plain_spgemm_matches_pallas(t, mask, monkeypatch):
    from repro.kernels.spgemm import ops as r_kops
    monkeypatch.setattr(csr_mod, "CHUNK_WEDGES", 50)     # several chunks
    rg, pg = ref_graph("a", t), port_graph("a", t)
    rm = ref_graph("m", t).ell if mask != "none" else None
    pm = port_graph("m", t).b2sr if mask != "none" else None
    comp = mask == "complement"
    want = np.asarray(r_kops.mxm(rg.ell, rg.ell, rm, comp, interpret=True))
    got = ref.spgemm_bbb(pg.b2sr, pg.b2sr, pm, complement=comp)
    assert np.array_equal(want, to_numpy_u32(P.b2sr_to_packed_grid(got)))
    assert got.nnz == int(np.unpackbits(want.view(np.uint8)).sum())


def test_spgemm_wrapper_checks_its_inputs():
    a = port_graph("a", 8).b2sr
    with pytest.raises(ValueError, match="tile_dim"):
        spgemm.spgemm_bbb(a, port_graph("a", 16).b2sr)
    with pytest.raises(ValueError, match="mask is"):
        spgemm.spgemm_bbb(a, a, P.coo_to_b2sr([0], [1], N, N + 3, 8, "cpu"))
    with pytest.raises(ValueError, match="913408"):
        common.check_bitmap_width(common.ROW_BITMAP_MAX_TILE_COLS + 1, "B")
    before = spgemm.spgemm_bbb.launches
    spgemm.spgemm_bbb(a, a)                 # CPU: the plain version
    assert spgemm.spgemm_bbb.launches == before


# -- on the card ----------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("t", TILE_DIMS)
def test_spgemm_kernel_matches_plain_on_card(cuda, t):
    r, c = coo("a")
    mr, mc = coo("m")
    a = P.coo_to_b2sr(r, c, N, N, t, cuda)
    m = P.coo_to_b2sr(mr, mc, N, N, t, cuda)
    for mask, comp in ((None, False), (m, False), (m, True)):
        before = spgemm.spgemm_bbb.launches
        got = spgemm.spgemm_bbb(a, a, mask, complement=comp)
        assert spgemm.spgemm_bbb.launches == before + 1
        want = ref.spgemm_bbb(a, a, mask, complement=comp)
        for part in ("tile_row_ptr", "tile_col_idx", "bit_tiles"):
            assert torch.equal(getattr(got, part), getattr(want, part))
        assert got.nnz == want.nnz
