"""PyTorch port vs the JAX reference: the dense and count mxv rows.

The same seeded graph and vectors go through ``repro`` (``b2sr``) and
``repro_torch`` (``b2sr``, ``b2sr_cuda`` and ``csr``, buckets on and off,
all on the CPU; ``b2sr_cuda`` on a CPU graph runs the kernels' plain
versions). Tolerances: min-plus, max-times, boolean and count outputs are
exact; arithmetic sums are allclose with ``rtol=1e-5, atol=1e-6``, since
each backend adds at most ~60 float32 terms per row in its own order
(a few ulps apart). The tests marked ``cuda`` hold the kernels against
their plain versions on the card and skip here.
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
    from repro.core.operands import BitVector as RBitVector
    from repro.core.semiring import SEMIRINGS as R_SEMIRINGS
    from repro.kernels.bmv import ops as r_kops
except ImportError:                      # a card's machine without JAX
    jnp = None

from repro_torch.core.descriptor import Descriptor  # noqa: E402
from repro_torch.core.graphblas import GraphMatrix  # noqa: E402
from repro_torch.core.operands import BitVector  # noqa: E402
from repro_torch.core.semiring import BOOLEAN, SEMIRINGS  # noqa: E402
from repro_torch.core.words import from_numpy_u32  # noqa: E402
from repro_torch.data import graphs as PG  # noqa: E402
from repro_torch.kernels.bmv import bmv, ref  # noqa: E402

needs_reference = pytest.mark.skipif(
    jnp is None, reason="the JAX reference package needs jax")

N = 200                                   # not a multiple of 16 or 32
T = 8
A_VALUES = (1.0, 0.5, 0.0)
RTOL, ATOL = 1e-5, 1e-6
BACKEND_CASES = (("b2sr", False), ("b2sr", True), ("b2sr_cuda", False),
                 ("b2sr_cuda", True), ("csr", False))
#: plain; BitVector mask, complement; dense bool mask, keep; replace=False
#: with a BitVector mask; vxm (the stored transpose); row_chunk=5. Each
#: case runs the ``a_value``s given here (every value without a mask and
#: with one, at a third of the reference's CPU time).
CASES = {"plain": A_VALUES, "mask": (0.0,), "mask_keep": (1.0,),
         "no_replace": (0.5,), "vxm": (0.5,), "row_chunk": (0.0,)}
MODES = {"arithmetic": "sum", "min_plus": "min_plus",
         "max_times": "max_times"}


@functools.lru_cache(maxsize=None)
def graph_coo():
    r1, c1 = PG.rmat_graph(N, avg_degree=6, seed=1)
    r2, c2 = PG.dot_graph(N, density=0.01, seed=2)
    return PG._dedup_sym(np.concatenate([r1, r2]), np.concatenate([c1, c2]),
                         N)


@functools.lru_cache(maxsize=None)
def ref_graph():
    r, c = graph_coo()
    return RGraph.from_coo(r, c, N, N, T)


@functools.lru_cache(maxsize=None)
def port_graph():
    r, c = graph_coo()
    return GraphMatrix.from_coo(r, c, N, N, T, device="cpu")


def vectors(semiring: str, seed: int):
    """x, a 0/1 mask and a previous output, from a numpy seed."""
    rng = np.random.default_rng(seed)
    if semiring == "boolean":
        x = rng.random(N) < 0.3
        out = rng.random(N) < 0.5
    else:
        x = rng.random(N).astype(np.float32)
        if semiring == "max_times":
            x = 2 * x - 1                       # negative values too
        if semiring == "min_plus":
            x[rng.random(N) < 0.3] = np.inf    # unreached, as in SSSP
        out = rng.random(N).astype(np.float32)
    mask = (rng.random(N) < 0.5).astype(np.float32)
    return x, mask, out


def _desc(mod, bitvec, case, mask_np, t=T, n=N):
    """The case's descriptor for one package (``mod`` is its Descriptor)."""
    if case in ("plain", "vxm"):
        return mod()
    if case == "row_chunk":
        return mod(row_chunk=5)
    if case == "mask_keep":
        return mod(mask=mask_np != 0, complement=False)
    return mod(mask=bitvec.pack(mask_np, t, n), complement=True,
               replace=case != "no_replace")


@functools.lru_cache(maxsize=None)
def ref_dense(semiring, a_value, case):
    x, mask, out = vectors(semiring, len(case))
    rg = ref_graph()
    d = _desc(RDescriptor, RBitVector, case, jnp.asarray(mask))
    sr = R_SEMIRINGS[semiring]
    if case == "vxm":
        y = rg.vxm(jnp.asarray(x), sr, a_value=a_value)
    else:
        y = rg.mxv(jnp.asarray(x), sr, d, a_value=a_value,
                   out=jnp.asarray(out))
    return np.asarray(y)


def port_dense(g, semiring, a_value, case):
    x, mask, out = vectors(semiring, len(case))
    d = _desc(Descriptor, BitVector, case, torch.from_numpy(mask))
    sr = SEMIRINGS[semiring]
    if case == "vxm":
        return g.vxm(torch.from_numpy(x), sr, a_value=a_value)
    return g.mxv(torch.from_numpy(x), sr, d, a_value=a_value,
                 out=torch.from_numpy(out))


def assert_matches(semiring, want, got):
    assert got.shape == (N,)
    assert got.dtype == (torch.bool if semiring == "boolean"
                         else torch.float32)
    if semiring == "arithmetic":
        np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    else:
        assert np.array_equal(got.numpy(), want)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    return torch.device("cuda")


# -- the dense row: bin·full→full ---------------------------------------------

@needs_reference
@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("semiring", tuple(MODES))
@pytest.mark.parametrize("backend,buckets", BACKEND_CASES)
def test_dense_row_matches_reference(backend, buckets, semiring, case):
    g = port_graph().with_backend(backend).with_buckets(buckets)
    for a_value in CASES[case]:
        assert_matches(semiring, ref_dense(semiring, a_value, case),
                       port_dense(g, semiring, a_value, case))


@needs_reference
@pytest.mark.parametrize("case", ("plain", "mask", "no_replace"))
@pytest.mark.parametrize("backend,buckets", (("b2sr", False), ("b2sr", True),
                                             ("csr", False)))
def test_boolean_dense_row_matches_reference(backend, buckets, case):
    """The reference has the boolean dense row on ``b2sr`` and ``csr``,
    for a bool ``x``."""
    g = port_graph().with_backend(backend).with_buckets(buckets)
    for a_value in (1.0, 0.0):
        assert_matches("boolean", ref_dense("boolean", a_value, case),
                       port_dense(g, "boolean", a_value, case))


@needs_reference
def test_dense_row_rejects_what_the_reference_rejects():
    x = torch.rand(N)
    # the reference's b2sr_pallas row has no boolean kernel path
    with pytest.raises(NotImplementedError, match="boolean"):
        r_kops.bmv_bin_full_full(ref_graph().ell, jnp.asarray(x.numpy()),
                                 R_SEMIRINGS["boolean"])
    with pytest.raises(NotImplementedError, match="boolean"):
        port_graph().with_backend("b2sr_cuda").mxv(x > 0.5, BOOLEAN)
    # the reference's scan carry keeps x's dtype: boolean needs a bool x
    with pytest.raises(TypeError):
        ref_graph().mxv(jnp.asarray(x.numpy()), R_SEMIRINGS["boolean"])
    with pytest.raises(TypeError):
        port_graph().mxv(x, BOOLEAN)


# -- the count row: bin·bin→full ----------------------------------------------

@functools.lru_cache(maxsize=None)
def ref_count(out_dtype, case):
    x, mask, out = vectors("arithmetic", 10 + len(case))
    xb = RBitVector.pack(jnp.asarray(x < 0.3), T, N)
    d = _desc(RDescriptor, RBitVector, case, jnp.asarray(mask))
    rg = ref_graph()
    sr = R_SEMIRINGS["arithmetic"]
    dt = getattr(jnp, out_dtype)
    if case == "vxm":
        return np.asarray(rg.vxm(xb, sr, out_dtype=dt))
    return np.asarray(rg.mxv(xb, sr, d, out_dtype=dt,
                             out=jnp.asarray(out).astype(dt)))


@needs_reference
@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("out_dtype", ("float32", "int32"))
@pytest.mark.parametrize("backend,buckets", BACKEND_CASES)
def test_count_row_matches_reference(backend, buckets, out_dtype, case):
    x, mask, out = vectors("arithmetic", 10 + len(case))
    dt = getattr(torch, out_dtype)
    g = port_graph().with_backend(backend).with_buckets(buckets)
    xb = BitVector.pack(torch.from_numpy(x < 0.3), T, N)
    d = _desc(Descriptor, BitVector, case, torch.from_numpy(mask))
    sr = SEMIRINGS["arithmetic"]
    if case == "vxm":
        got = g.vxm(xb, sr, out_dtype=dt)
    else:
        got = g.mxv(xb, sr, d, out_dtype=dt,
                    out=torch.from_numpy(out).to(dt))
    assert got.dtype == dt and got.shape == (N,)
    assert np.array_equal(got.numpy(), ref_count(out_dtype, case))


# -- the kernels' plain versions against the reference's Pallas kernels ------

def _kernel_inputs():
    r, c = graph_coo()
    m = R.coo_to_b2sr(r, c, N, N, T)
    pm = GraphMatrix.from_coo(r, c, N, N, T, device="cpu").b2sr
    return R.to_ell(m), pm


@needs_reference
@pytest.mark.parametrize("semiring", tuple(MODES))
def test_plain_bff_matches_pallas(semiring):
    ell, pm = _kernel_inputs()
    x, _, _ = vectors(semiring, 3)
    want = r_kops.bmv_bin_full_full(ell, jnp.asarray(x),
                                    R_SEMIRINGS[semiring], a_value=0.5,
                                    interpret=True)
    pad = np.full(-(-N // T) * T - N,
                  0.0 if semiring == "arithmetic"
                  else SEMIRINGS[semiring].add_identity, np.float32)
    x3 = torch.from_numpy(np.concatenate([x, pad])).view(-1, T)
    args = (pm.tile_row_ptr, pm.tile_col_idx, pm.bit_tiles, x3)
    got = ref.bmv_bff(*args, t=T, mode=MODES[semiring], a_value=0.5)[:N]
    assert_matches(semiring, np.asarray(want), got)
    # the CPU wrapper path is the plain version, and counts no launch
    before = bmv.bmv_bff.launches
    assert torch.equal(bmv.bmv_bff(*args, t=T, mode=MODES[semiring],
                                   a_value=0.5)[:N], got)
    assert bmv.bmv_bff.launches == before


@needs_reference
def test_plain_bbf_matches_pallas():
    ell, pm = _kernel_inputs()
    x, _, _ = vectors("arithmetic", 4)
    xw = R.pack_bitvector(jnp.asarray(x < 0.4), T, N)
    want = r_kops.bmv_bin_bin_full(ell, xw, jnp.int32, interpret=True)
    args = (pm.tile_row_ptr, pm.tile_col_idx, pm.bit_tiles,
            from_numpy_u32(xw, "cpu"))
    got = ref.bmv_bbf(*args, t=T)
    assert got.dtype == torch.int32
    assert np.array_equal(np.asarray(want), got[:N].numpy())
    before = bmv.bmv_bbf.launches
    assert torch.equal(bmv.bmv_bbf(*args, t=T), got)
    assert bmv.bmv_bbf.launches == before


def test_plain_versions_chunk_the_tiles():
    """A chunk of a few tiles gives the same result as one chunk."""
    pm = port_graph().b2sr
    rng = np.random.default_rng(7)
    x3 = torch.from_numpy(rng.random((pm.n_tile_cols, T)).astype(np.float32))
    xw = pm.tile_col_idx.new_tensor(
        rng.integers(-2 ** 31, 2 ** 31, pm.n_tile_cols))
    args = (pm.tile_row_ptr, pm.tile_col_idx, pm.bit_tiles)
    for mode in ref.BFF_MODES:
        assert torch.equal(
            ref.bmv_bff(*args, x3, t=T, mode=mode, chunk_words=3 * T * T),
            ref.bmv_bff(*args, x3, t=T, mode=mode))
    assert torch.equal(ref.bmv_bbf(*args, xw, t=T, chunk_words=5 * T * T),
                       ref.bmv_bbf(*args, xw, t=T))


def test_bff_wrapper_rejects_unknown_mode():
    pm = port_graph().b2sr
    with pytest.raises(ValueError, match="mode"):
        bmv.bmv_bff(pm.tile_row_ptr, pm.tile_col_idx, pm.bit_tiles,
                    torch.zeros(pm.n_tile_cols, T), t=T, mode="boolean")


# -- on the card ----------------------------------------------------------------

def _sum_bound(args, x3, t, a_value):
    """1e-5 · (A·|a_value·x|): the stated elementwise bound of the sum mode."""
    return 1e-5 * ref.bmv_bff(*args, x3.abs(), t=t, mode="sum",
                              a_value=abs(a_value))


@pytest.mark.cuda
@pytest.mark.parametrize("t", (4, 8, 16, 32))
def test_bff_kernel_matches_plain_on_card(cuda, t):
    r, c = graph_coo()
    g = GraphMatrix.from_coo(r, c, N, N, t, device=cuda)
    m = g.b2sr
    args = (m.tile_row_ptr, m.tile_col_idx, m.bit_tiles)
    rng = np.random.default_rng(t)
    x3 = torch.as_tensor(rng.random((m.n_tile_cols, t), dtype=np.float32),
                         device=cuda)
    x3[torch.as_tensor(rng.random(x3.shape) < 0.2, device=cuda)] = np.inf
    for mode in ref.BFF_MODES:
        xm = torch.where(torch.isinf(x3), 0.0, x3) if mode != "min_plus" \
            else x3
        for a_value in (1.0, 0.5, 0.0):
            before = bmv.bmv_bff.launches
            got = bmv.bmv_bff(*args, xm, t=t, mode=mode, a_value=a_value)
            assert bmv.bmv_bff.launches == before + 1
            want = ref.bmv_bff(*args, xm, t=t, mode=mode, a_value=a_value)
            if mode == "sum":
                err = (got - want).abs()
                assert bool((err <= _sum_bound(args, xm, t, a_value)).all())
            else:
                assert torch.equal(got, want), (mode, a_value)
    with pytest.raises(TypeError):
        bmv.bmv_bff(*args, x3.double(), t=t, mode="sum")


@pytest.mark.cuda
@pytest.mark.parametrize("t", (4, 8, 16, 32))
def test_bbf_kernel_matches_plain_on_card(cuda, t):
    r, c = graph_coo()
    g = GraphMatrix.from_coo(r, c, N, N, t, device=cuda)
    m = g.b2sr
    rng = np.random.default_rng(t)
    for dens in (0.01, 0.3, 1.0):
        x = g.pack(torch.as_tensor(rng.random(N) < dens, device=cuda))
        args = (m.tile_row_ptr, m.tile_col_idx, m.bit_tiles, x)
        before = bmv.bmv_bbf.launches
        got = bmv.bmv_bbf(*args, t=t)
        assert bmv.bmv_bbf.launches == before + 1
        assert torch.equal(got, ref.bmv_bbf(*args, t=t)), dens
