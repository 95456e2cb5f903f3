"""PyTorch port vs the JAX reference: B2SR format, packed words, bmv kernels.

The same seeded COO graphs go through ``repro`` (JAX, Pallas in interpret
mode on the CPU) and ``repro_torch`` (plain PyTorch on the CPU); every
array and every output word must be equal (tolerance: exact, all values
are integers or bit patterns). Kernel tests that need a card are marked
``cuda`` and skip here; they need no JAX, so on a machine with a card
and without JAX ``python -m pytest -m cuda tests/test_torch_*.py`` runs
them while the reference tests skip.
"""

from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

try:
    import jax
    from repro.core import b2sr as R
    from repro.core import ops as r_ops
    from repro.data import graphs as RG
    from repro.kernels.bmv import ops as r_kops
except ImportError:                      # a card's machine without JAX
    jax = None

from repro_torch.core import b2sr as P  # noqa: E402
from repro_torch.core.graphblas import GraphMatrix  # noqa: E402
from repro_torch.core.words import (from_numpy_u32, lane_mask, lshr,  # noqa: E402
                                    pack_bits, popcount, to_numpy_u32,
                                    unpack_bits)
from repro_torch.data import graphs as PG  # noqa: E402
from repro_torch.kernels.bmv import bmv, ref  # noqa: E402

needs_reference = pytest.mark.skipif(
    jax is None, reason="the JAX reference package needs jax")
ROOT = Path(__file__).resolve().parents[1]
TILE_DIMS = (4, 8, 16, 32)
GRAPHS = {
    "dot": (lambda g: g.dot_graph(200, 0.03, seed=1), 200),
    "powerlaw": (lambda g: g.powerlaw_graph(250, 6, seed=2), 250),
    "rmat": (lambda g: g.rmat_graph(256, 6, seed=3), 256),
    "road": (lambda g: g.road_graph(15), 225),
}


def coo(name):
    make, n = GRAPHS[name]
    r, c = make(PG)
    return r, c, n


def same(ref_arr, port_arr) -> bool:
    """Reference array (jax/numpy) vs port tensor, as uint32 / int32 bits."""
    a = np.asarray(ref_arr)
    if a.dtype == np.uint32:
        return np.array_equal(a, to_numpy_u32(port_arr))
    return np.array_equal(a, port_arr.cpu().numpy())


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    return torch.device("cuda")


# -- generators and packed words --------------------------------------------

@needs_reference
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_generators_match_reference(name):
    make, _ = GRAPHS[name]
    for a, b in zip(make(RG), make(PG)):
        assert np.array_equal(a, b)


def test_word_helpers():
    rng = np.random.default_rng(0)
    w = rng.integers(0, 2 ** 32, 4096, dtype=np.uint64).astype(np.uint32)
    w[:4] = (0, 0xFFFFFFFF, 0x80000000, 1)
    x = from_numpy_u32(w, "cpu")
    assert x.dtype == torch.int32
    assert np.array_equal(to_numpy_u32(x), w)
    assert np.array_equal(popcount(x).numpy(), np.bitwise_count(w))
    for s in (0, 1, 7, 31):
        assert np.array_equal(to_numpy_u32(lshr(x, s)), w >> np.uint32(s))
    assert np.array_equal(to_numpy_u32(pack_bits(unpack_bits(x, 32))), w)
    for t in TILE_DIMS:
        assert np.uint32(np.int32(lane_mask(t)).view(np.uint32)) == \
            np.uint32((1 << t) - 1)


@needs_reference
@pytest.mark.parametrize("t", TILE_DIMS)
def test_pack_unpack_match_reference(t):
    rng = np.random.default_rng(t)
    v = (rng.random(203) < 0.3).astype(np.float32)
    words = R.pack_bitvector(jax.numpy.asarray(v), t, 203)
    pw = P.pack_bitvector(torch.from_numpy(v), t, 203)
    assert same(words, pw)
    assert np.array_equal(np.asarray(R.unpack_bitvector(words, t, 203)),
                          P.unpack_bitvector(pw, t, 203).numpy())
    assert np.array_equal(np.asarray(R.unpack_tiles(words, t)),
                          P.unpack_tiles(pw, t).numpy())


# -- (a) format: B2SR, ELL, bucketed, transpose, COO round trip --------------

@needs_reference
@pytest.mark.parametrize("t", TILE_DIMS)
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_format_matches_reference(name, t):
    r, c, n = coo(name)
    m = R.coo_to_b2sr(r, c, n, n, t)
    pm = P.coo_to_b2sr(r, c, n, n, t, device="cpu")
    for f in ("tile_row_ptr", "tile_col_idx", "bit_tiles"):
        assert same(getattr(m, f), getattr(pm, f)), f
    assert (m.nnz, m.n_tiles) == (pm.nnz, pm.n_tiles)

    e, pe = R.to_ell(m), P.to_ell(pm)
    for f in ("tile_col_idx", "bit_tiles", "row_n_tiles"):
        assert same(getattr(e, f), getattr(pe, f)), f

    for max_buckets in (8, 2):          # 2 forces the hub-bucket merge
        b = R.to_bucketed(e, max_buckets)
        pb = P.to_bucketed(pm, max_buckets)
        assert b.n_buckets == pb.n_buckets
        for i in range(b.n_buckets):
            assert same(b.col_idx[i], pb.col_idx[i])
            assert same(b.bit_tiles[i], pb.bit_tiles[i])
            assert same(b.rows[i], pb.rows[i])

    mt, pmt = R.transpose(m), P.transpose(pm)
    for f in ("tile_row_ptr", "tile_col_idx", "bit_tiles"):
        assert same(getattr(mt, f), getattr(pmt, f)), f
    assert mt.nnz == pmt.nnz

    rr, cc = R.b2sr_to_coo(m)
    pr, pc = P.b2sr_to_coo(pm, chunk_words=t * t * 7)   # several chunks
    assert np.array_equal(rr, pr.numpy()) and np.array_equal(cc, pc.numpy())


@needs_reference
@pytest.mark.parametrize("t", (8, 32))
def test_graph_views_match_reference(t):
    from repro.core.graphblas import GraphMatrix as RGraph
    r, c, n = coo("rmat")
    rg = RGraph.from_coo(r, c, n, n, t)
    pg = GraphMatrix.from_coo(r, c, n, n, t, device="cpu")
    for rv, pv in ((rg, pg), (rg.transposed(), pg.transposed())):
        assert same(rv.ell.tile_col_idx, pv.ell.tile_col_idx)
        assert same(rv.ell.bit_tiles, pv.ell.bit_tiles)
        for a, b in zip(rv.buckets().bit_tiles, pv.buckets().bit_tiles):
            assert same(a, b)
        assert same(rv.csr.col_idx, pv.csr.col_idx)
        assert same(rv.csr.row_ptr, pv.csr.row_ptr)
    assert pg.transposed().transposed() is pg


def test_out_of_range_coo_rejected():
    with pytest.raises(ValueError):
        P.coo_to_b2sr(np.array([5]), np.array([0]), 4, 4, 4, device="cpu")
    with pytest.raises(ValueError):
        P.coo_to_b2sr(np.array([0]), np.array([0]), 4, 4, 3, device="cpu")


# -- (b) kernel modules: the plain versions vs Pallas and the jnp rows ------

def _bmv_inputs(t, seed):
    r, c, n = coo("rmat")
    m = R.coo_to_b2sr(r, c, n, n, t)
    rng = np.random.default_rng(seed)
    xv = (rng.random(n) < 0.2).astype(np.float32)
    mv = (rng.random(n) < 0.5).astype(np.float32)
    x = R.pack_bitvector(jax.numpy.asarray(xv), t, n)
    mask = R.pack_bitvector(jax.numpy.asarray(mv), t, n)
    pm = P.coo_to_b2sr(r, c, n, n, t, device="cpu")
    return m, pm, x, mask


@needs_reference
@pytest.mark.parametrize("complement", (True, False))
@pytest.mark.parametrize("t", TILE_DIMS)
def test_bmv_plain_matches_reference(t, complement):
    m, pm, x, mask = _bmv_inputs(t, seed=t + complement)
    ell = R.to_ell(m)
    px, pmask = from_numpy_u32(x, "cpu"), from_numpy_u32(mask, "cpu")
    args = (pm.tile_row_ptr, pm.tile_col_idx, pm.bit_tiles, px, pmask)
    push = ref.bmv_bbb_push(*args, t=t, complement=complement)
    pull = ref.bmv_bbb_pull(*args, t=t, complement=complement)

    pallas_push = r_kops.bmv_bin_bin_bin(ell, x, mask, complement,
                                         interpret=True)
    pallas_pull = r_kops.bmv_bin_bin_bin_pull(ell, x, mask, complement,
                                              interpret=True)
    jnp_push = r_ops.bmv_bin_bin_bin_masked(ell, x, mask, complement)
    for want in (pallas_push, pallas_pull, jnp_push):
        assert same(want, push)
        assert same(want, pull)
    # the CPU wrapper path is the plain version
    assert torch.equal(bmv.bmv_bbb_push(*args, t=t, complement=complement),
                       push)
    assert torch.equal(bmv.bmv_bbb_pull(*args, t=t, complement=complement),
                       pull)


@needs_reference
def test_bmv_plain_unmasked_push_matches_reference():
    m, pm, x, _ = _bmv_inputs(8, seed=0)
    want = r_kops.bmv_bin_bin_bin(R.to_ell(m), x, None, interpret=True)
    got = ref.bmv_bbb_push(pm.tile_row_ptr, pm.tile_col_idx, pm.bit_tiles,
                           from_numpy_u32(x, "cpu"), None, t=8)
    assert same(want, got)
    assert same(r_ops.bmv_bin_bin_bin(R.to_ell(m), x), got)


@needs_reference
def test_cpu_wrappers_do_not_count_launches():
    _, pm, x, mask = _bmv_inputs(8, seed=1)
    before = (bmv.bmv_bbb_push.launches, bmv.bmv_bbb_pull.launches)
    args = (pm.tile_row_ptr, pm.tile_col_idx, pm.bit_tiles,
            from_numpy_u32(x, "cpu"), from_numpy_u32(mask, "cpu"))
    bmv.bmv_bbb_push(*args, t=8)
    bmv.bmv_bbb_pull(*args, t=8)
    assert (bmv.bmv_bbb_push.launches, bmv.bmv_bbb_pull.launches) == before


# -- entry-point rules --------------------------------------------------------

def test_no_silent_cpu_fallback(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    r, c, n = coo("road")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        GraphMatrix.from_coo(r, c, n, n, 8)            # device=None is CUDA
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        P.coo_to_b2sr(r, c, n, n, 8)


def test_package_imports_without_jax_or_reference():
    code = ("import sys, repro_torch, repro_torch.algorithms, "
            "repro_torch.convert, repro_torch.core.ops, "
            "repro_torch.core.csr_backend, repro_torch.kernels.bmv.ops, "
            "repro_torch.data.graphs, chip_smoke\n"
            "bad = sorted(m for m in sys.modules "
            "if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
            "assert not bad, bad\n")
    env = {**os.environ, "PYTHONPATH": "src"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


# -- on the card --------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("t", TILE_DIMS)
def test_kernels_match_plain_on_card(cuda, t):
    r, c, n = coo("rmat")
    g = GraphMatrix.from_coo(r, c, n, n, t, device=cuda)
    m = g.b2sr
    rng = np.random.default_rng(t)
    for dens in (0.01, 0.3, 0.9):
        x = g.pack(torch.as_tensor(rng.random(n) < dens, device=cuda))
        mask = g.pack_rows(torch.as_tensor(rng.random(n) < 0.5, device=cuda))
        for comp in (True, False):
            args = (m.tile_row_ptr, m.tile_col_idx, m.bit_tiles, x, mask)
            for k in ("bmv_bbb_push", "bmv_bbb_pull"):
                before = getattr(bmv, k).launches
                got = getattr(bmv, k)(*args, t=t, complement=comp)
                assert getattr(bmv, k).launches == before + 1
                want = getattr(ref, k)(*args, t=t, complement=comp)
                assert torch.equal(got, want), (k, dens, comp)
