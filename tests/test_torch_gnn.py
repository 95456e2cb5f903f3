"""PyTorch port vs the JAX reference: BitGNN inference.

The same numpy-seeded graphs, activations, features and weights go
through ``repro`` and ``repro_torch`` on the CPU (``b2sr_cuda`` on a CPU
graph runs the kernels' plain versions). Backend pairs as in
``test_torch_spmm.py``: ``b2sr`` against ``b2sr`` (buckets on and off),
``b2sr_cuda`` against ``b2sr_pallas`` (Pallas in interpret mode), ``csr``
against ``csr``. Tolerances:

  - the bitmat mxm counts are integers: equal, in float32 and int32;
  - STE forwards equal; backwards equal to ``jax.grad`` of the reference;
  - float aggregations, the GCN forward and ``gnn_infer`` logits within
    ``atol 1e-5`` (the reference test's own tolerance): the sums run in
    other orders on the two sides.

The tests marked ``cuda`` hold ``spmm_bbf`` against its plain version
and the rows against ``csr`` on the card, and skip here.
"""

from __future__ import annotations

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

try:
    import jax
    import jax.numpy as jnp
    from repro.core.graphblas import GraphMatrix as RGraph
    from repro.core.operands import BitMatrix as RBitMatrix
except ImportError:                      # a card's machine without JAX
    jnp = None

from repro_torch import convert  # noqa: E402
from repro_torch.configs import gcn_cora  # noqa: E402
from repro_torch.core import dispatch  # noqa: E402
from repro_torch.core.descriptor import Descriptor  # noqa: E402
from repro_torch.core.graphblas import GraphMatrix  # noqa: E402
from repro_torch.core.mesh import make_mesh  # noqa: E402
from repro_torch.core.operands import BitMatrix  # noqa: E402
from repro_torch.core.semiring import BOOLEAN  # noqa: E402
from repro_torch.data import graphs as PG  # noqa: E402
from repro_torch.engine import QueryBatcher, queries  # noqa: E402
from repro_torch.engine.batcher import validate_query  # noqa: E402
from repro_torch.gnn_bit import binarize, layers  # noqa: E402
from repro_torch.kernels.spmm import ref, spmm  # noqa: E402
from repro_torch.models.gnn.common import GraphBatch  # noqa: E402
from repro_torch.models.gnn.gcn import GCN  # noqa: E402

needs_reference = pytest.mark.skipif(
    jnp is None, reason="the JAX reference package needs jax")

N = 44                                    # not a multiple of 8, 16 or 32
ATOL = 1e-5
#: (port backend, buckets, reference backend)
BACKEND_CASES = (("b2sr", False, "b2sr"), ("b2sr", True, "b2sr"),
                 ("b2sr_cuda", False, "b2sr_pallas"), ("csr", False, "csr"))
#: feature widths, ragged against the reference's block_d of 128
WIDTH = {4: 5, 8: 1, 16: 130, 32: 5}


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


def sparse_x(seed: int, d: int, n: int = N) -> np.ndarray:
    """Random features with a majority of zeros (``x != 0`` is the bit)."""
    x = np.random.default_rng(seed).standard_normal((n, d)).astype(
        np.float32)
    x[x < 0.3] = 0.0
    return x


def bitmats(t: int, d: int, seed: int):
    """The same BitMatrix for both packages."""
    rb = RBitMatrix.pack(jnp.asarray(sparse_x(seed, d)), t)
    return rb, convert.bitmatrix_from_reference(np.asarray(rb.words), N, t,
                                                device="cpu")


# -- the bitmat rows through GraphMatrix.mxm ----------------------------------------

@needs_reference
@pytest.mark.parametrize("backend,buckets,ref_backend", BACKEND_CASES)
@pytest.mark.parametrize("t", (4, 8, 16, 32))
def test_bitmat_rows_match_reference(t, backend, buckets, ref_backend):
    d = WIDTH[t]
    rb, pb = bitmats(t, d, t)
    m = np.random.default_rng(t + 1).random(N) < 0.5
    rg, pg = ref_graph(t, ref_backend, buckets), port_graph(t, backend,
                                                            buckets)
    want_counts = (PG_dense(t).astype(np.float32)
                   @ (sparse_x(t, d) != 0).astype(np.float32))
    for mask, dtype in (("none", "float32"), ("keep", "int32"),
                        ("complement", "float32")):
        rkw, pkw = {}, {}
        if mask != "none":
            comp = mask == "complement"
            rkw = dict(mask=jnp.asarray(m), complement=comp)
            pkw = dict(mask=torch.from_numpy(m), complement=comp)
        want = np.asarray(rg.mxm(rb, out_dtype=getattr(jnp, dtype), **rkw))
        got = pg.mxm(pb, out_dtype=getattr(torch, dtype), **pkw)
        assert got.dtype == getattr(torch, dtype)
        assert tuple(got.shape) == (N, d)
        assert np.array_equal(got.numpy(), want), (mask, dtype)
        if mask == "none":
            assert np.array_equal(got.numpy(), want_counts)


@functools.lru_cache(maxsize=None)
def PG_dense(t: int) -> np.ndarray:
    r, c = coo()
    a = np.zeros((N, N), np.int64)
    a[r, c] = 1
    return a


def test_bitmat_mxm_checks_and_merges():
    t = 8
    g = port_graph(t, "b2sr", False)
    x = sparse_x(1, 3)
    bm = BitMatrix.pack(torch.from_numpy(x), t)
    assert torch.equal(bm.unpack(), torch.from_numpy((x != 0).astype(
        np.float32)))
    with pytest.raises(NotImplementedError, match="arithmetic"):
        g.mxm(bm, BOOLEAN)
    with pytest.raises(ValueError, match="tile_dim"):
        g.mxm(BitMatrix.pack(torch.from_numpy(x), 4))
    with pytest.raises(ValueError, match="length"):
        g.mxm(BitMatrix.pack(torch.from_numpy(sparse_x(1, 3, N + 8)), t))
    with pytest.raises(TypeError, match="int32"):
        BitMatrix.from_words(bm.words.to(torch.int64), N, t)
    counts = g.mxm(bm)
    bits = (x != 0).astype(np.int64)
    assert np.array_equal(counts.numpy(), PG_dense(t) @ bits)
    # Aᵀ through the descriptor, with the dtype carried along
    got = g.mxm(bm, desc=Descriptor(transpose_a=True), out_dtype=torch.int32)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), PG_dense(t).T @ bits)
    rows = torch.from_numpy(np.arange(N) % 3 == 0)
    out = torch.full((N, 3), -1.0)
    merged = g.mxm(bm, desc=Descriptor(mask=rows, replace=False), out=out)
    assert torch.equal(merged, torch.where(rows[:, None], counts, out))
    assert bool(bm.any()) and not bool((bm & ~bm).any())
    assert torch.equal((bm | ~bm).unpack(), torch.ones(N, 3))


# -- binarization ------------------------------------------------------------------

@needs_reference
def test_ste_forward_and_gradient_match_reference():
    from repro.gnn_bit import binarize as rbin
    x = np.array([-2.0, -1.0, -0.6, -0.0, 0.0, 0.4, 1.0, 1.3, 3.0],
                 np.float32)
    w = np.array([0.5, -1.0, 2.0, 1.5, -0.7, 3.0, 0.25, -2.0, 1.0],
                 np.float32)
    for rf, pf in ((rbin.ste_sign, binarize.ste_sign),
                   (rbin.ste_step, binarize.ste_step)):
        xt = torch.from_numpy(x).requires_grad_(True)
        y = pf(xt)
        assert np.array_equal(y.detach().numpy(), np.asarray(rf(
            jnp.asarray(x))))
        (y * torch.from_numpy(w)).sum().backward()
        want = jax.grad(lambda v: jnp.sum(rf(v) * jnp.asarray(w)))(
            jnp.asarray(x))
        assert np.array_equal(xt.grad.numpy(), np.asarray(want))
    xr = np.random.default_rng(0).standard_normal((N, 6)).astype(np.float32)
    xb, alpha = binarize.binarize(torch.from_numpy(xr))
    rxb, ralpha = rbin.binarize(jnp.asarray(xr))
    assert np.array_equal(xb.numpy(), np.asarray(rxb))
    np.testing.assert_allclose(alpha.numpy(), np.asarray(ralpha), rtol=1e-6)


# -- aggregation layers ------------------------------------------------------------

@needs_reference
@pytest.mark.parametrize("backend,buckets,ref_backend", BACKEND_CASES)
def test_layers_match_reference(backend, buckets, ref_backend):
    from repro.gnn_bit import layers as rlayers
    t = 8
    rg = ref_graph(t, "b2sr", False)
    pg = port_graph(t, backend, buckets)
    x = np.random.default_rng(5).standard_normal((N, 7)).astype(np.float32)
    rowsum = PG_dense(t).sum(1).astype(np.float32)
    # the reference's layers wrap a bare ELL view, which has no CSR twin:
    # the port's csr rows are held against the reference's b2sr rows
    rkw = dict(backend="b2sr" if ref_backend == "csr" else ref_backend,
               use_buckets=buckets)
    want = np.asarray(rlayers.aggregate(rg.ell, jnp.asarray(x), **rkw))
    got = layers.aggregate(pg, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)
    want = np.asarray(rlayers.signed_aggregate(
        rg.ell, jnp.asarray(x), jnp.asarray(rowsum), **rkw))
    got = layers.signed_aggregate(pg, torch.from_numpy(x),
                                  torch.from_numpy(rowsum))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)
    # exact on ±1 inputs with α = 1, against a dense numpy product
    s = np.where(x >= 0, 1.0, -1.0).astype(np.float32)
    got = layers.signed_aggregate(pg.b2sr, torch.from_numpy(s),
                                  torch.from_numpy(rowsum), backend=backend,
                                  alpha=torch.ones(7))
    assert np.array_equal(got.numpy(), PG_dense(t).astype(np.float32) @ s)
    bm = binarize.pack_activations(torch.from_numpy(x), t)
    want = np.asarray(rlayers.binary_aggregate(
        rg.ell, RBitMatrix.pack(jnp.asarray(x > 0), t),
        out_dtype=jnp.int32, **rkw))
    got = layers.binary_aggregate(pg, bm, out_dtype=torch.int32)
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)
    # axes=: the sharded rows over a prepared 2-slot CPU mesh (csr has
    # none and refuses)
    mesh = make_mesh((2,), ("data",), ["cpu"] * 2)
    if backend == "csr":
        with pytest.raises(ValueError, match="csr"):
            layers.prepare_sharded(pg, ("data",), mesh=mesh)
    else:
        layers.prepare_sharded(pg, ("data",), mesh=mesh)
        got = layers.aggregate(pg, torch.from_numpy(x), axes=("data",))
        assert dispatch.last_key[6]
        want = np.asarray(rlayers.aggregate(rg.ell, jnp.asarray(x), **rkw))
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)


# -- the GCN forward ---------------------------------------------------------------

def _port_batch(rbatch, backend: str) -> GraphBatch:
    """The reference's full-graph batch as the port's (the ELL view's
    B2SR wrapped as a GraphMatrix, rows = receivers)."""
    ell = rbatch.ell
    graph = None
    if ell is not None:
        m = convert.from_reference(
            {"ell.tile_col_idx": np.asarray(ell.tile_col_idx),
             "ell.bit_tiles": np.asarray(ell.bit_tiles),
             "ell.row_n_tiles": np.asarray(ell.row_n_tiles)},
            {"tile_dim": ell.tile_dim, "n_rows": ell.n_rows,
             "n_cols": ell.n_cols,
             "nnz": int(np.asarray(rbatch.edge_mask).sum())}, device="cpu")
        graph = GraphMatrix.from_b2sr(m, with_transpose=False,
                                      backend=backend)

    def tensor(a, dtype=None):
        return torch.tensor(np.asarray(a, dtype=dtype))

    return GraphBatch(
        node_feat=tensor(rbatch.node_feat),
        senders=tensor(rbatch.senders, np.int64),
        receivers=tensor(rbatch.receivers, np.int64),
        edge_mask=tensor(rbatch.edge_mask), graph=graph,
        degrees=tensor(rbatch.degrees))


@needs_reference
@pytest.mark.parametrize("use_b2sr", (True, False))
def test_gcn_forward_matches_reference(use_b2sr):
    import dataclasses
    from repro.configs import gcn_cora as rcora
    from repro.data.synthetic import full_graph_batch
    from repro.models.gnn import gcn as rgcn
    rcfg = dataclasses.replace(rcora.reduced(), use_b2sr=use_b2sr)
    cfg = dataclasses.replace(gcn_cora.reduced(), use_b2sr=use_b2sr)
    assert (cfg.d_in, cfg.d_hidden, cfg.n_classes, cfg.n_layers,
            cfg.norm) == (rcfg.d_in, rcfg.d_hidden, rcfg.n_classes,
                          rcfg.n_layers, rcfg.norm)
    rbatch = full_graph_batch(rcfg, 96, pattern="block", seed=3,
                              with_b2sr=True)
    params = rgcn.init_params(rcfg, jax.random.PRNGKey(0))
    want = np.asarray(rgcn.forward(params, rbatch, rcfg))
    model = GCN(cfg)
    model.load_state_dict(convert.gcn_state_from_reference(
        jax.tree_util.tree_map(np.asarray, params), device="cpu"))
    backends = ("b2sr", "b2sr_cuda", "csr") if use_b2sr else ("b2sr",)
    for backend in backends:
        with torch.no_grad():
            got = model(_port_batch(rbatch, backend))
        assert tuple(got.shape) == (96, cfg.n_classes)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)
    # the mean-aggregation variant (norm="none") and degrees from edges
    cfg_mean = dataclasses.replace(cfg, norm="none")
    rcfg_mean = dataclasses.replace(rcfg, norm="none")
    want = np.asarray(rgcn.forward(params, rbatch.replace(degrees=None),
                                   rcfg_mean))
    model.cfg = cfg_mean
    with torch.no_grad():
        got = model(dataclasses.replace(_port_batch(rbatch, "b2sr"),
                                        degrees=None))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)


# -- gnn_infer serving -------------------------------------------------------------

def _serving_setup(binarize_model: bool, name: str):
    """The reference test's setup, registered in both packages."""
    rng = np.random.RandomState(4)
    n, t, d_in, d_h, n_cls = 64, 8, 12, 8, 4
    d = (rng.rand(n, n) < 0.12).astype(np.uint8)
    feats = rng.randn(n, d_in).astype(np.float32)
    params = [(rng.randn(d_in, d_h).astype(np.float32) * 0.3,
               np.zeros(d_h, np.float32)),
              (rng.randn(d_h, n_cls).astype(np.float32) * 0.3,
               np.zeros(n_cls, np.float32))]
    queries.register_gnn_model(
        name, binarize=binarize_model,
        **convert.gnn_model_from_reference(params, feats, device="cpu"))
    return d, t, params, feats


@needs_reference
@pytest.mark.parametrize("binarize_model", (True, False))
def test_gnn_infer_matches_reference(binarize_model):
    from repro.engine import queries as rqueries
    name = f"gnn-test-{binarize_model}"
    d, t, params, feats = _serving_setup(binarize_model, name)
    rqueries.register_gnn_model(name, params, feats,
                                binarize=binarize_model)
    nodes = [3, 9, 41, 9, 63]
    want = np.asarray(rqueries.gnn_infer(RGraph.from_dense(d, tile_dim=t),
                                         nodes, name).logits)
    for backend in ("b2sr", "b2sr_cuda", "csr"):
        g = GraphMatrix.from_dense(torch.from_numpy(d), tile_dim=t,
                                   device="cpu", backend=backend)
        res = queries.gnn_infer(g, nodes, name)
        assert res.n_layers == 2 and tuple(res.logits.shape) == (4, 5)
        np.testing.assert_allclose(res.logits.numpy(), want, rtol=0,
                                   atol=ATOL)


def test_batcher_gnn_infer_handles_equal_columns():
    d, t, _, _ = _serving_setup(True, "gnn-batcher")
    g = GraphMatrix.from_dense(torch.from_numpy(d), tile_dim=t, device="cpu")
    nodes = (3, 9, 41, 9)
    direct = queries.gnn_infer(g, nodes, "gnn-batcher").logits
    b = QueryBatcher()
    handles = [b.gnn_infer(g, s, "gnn-batcher") for s in nodes]
    handles.append(b.bfs(g, 5))                  # another group
    b.flush()
    for i, h in enumerate(handles[:4]):
        np.testing.assert_allclose(h.result().numpy(),
                                   direct[:, i].numpy(), rtol=0, atol=ATOL)
    assert b.n_deduped == 1 and b.n_launches == 2


def test_gnn_infer_unknown_model_and_bad_node():
    d, t, _, _ = _serving_setup(True, "gnn-errors")
    g = GraphMatrix.from_dense(torch.from_numpy(d), tile_dim=t, device="cpu")
    with pytest.raises(ValueError, match="no GNN model registered"):
        queries.gnn_infer(g, [0], "nope")
    with pytest.raises(ValueError, match="out of range"):
        validate_query(g, "gnn_infer", 10_000)
    with pytest.raises(ValueError, match="out of range"):
        queries.gnn_infer(g, [64], "gnn-errors")
    small = GraphMatrix.from_dense(torch.eye(8), tile_dim=t, device="cpu")
    with pytest.raises(ValueError, match="features cover"):
        queries.gnn_infer(small, [0], "gnn-errors")
    # registering again bumps the version, so plans never go stale
    v0 = queries._gnn_model("gnn-errors").version
    _serving_setup(True, "gnn-errors")
    assert queries._gnn_model("gnn-errors").version == v0 + 1


# -- on the card ---------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("t", (4, 8, 16, 32))
def test_spmm_bbf_matches_plain_on_card(cuda, t):
    from repro_torch.core.b2sr import coo_to_b2sr, pack_bitmatrix
    n = 700
    r, c = PG.rmat_graph(n, avg_degree=12, seed=t)
    m = coo_to_b2sr(r, c, n, n, t, cuda)
    cut = spmm.work_items(m, 3)        # rows merged from several items
    rng = np.random.default_rng(t)
    for d in (1, 16, 33, 130):
        xw = pack_bitmatrix(torch.from_numpy(rng.random((n, d)) < 0.3).to(
            cuda), t)
        want = ref.spmm_bbf(m, xw, torch.int32)
        for items in (None, cut):
            before = spmm.spmm_bbf.launches
            got = spmm.spmm_bbf(m, xw, torch.int32, items=items)
            assert spmm.spmm_bbf.launches == before + 1
            assert torch.equal(got, want), (t, d)
        assert torch.equal(spmm.spmm_bbf(m, xw), want.float())


@pytest.mark.cuda
def test_cuda_gnn_path_matches_csr(cuda):
    d, t, _, _ = _serving_setup(True, "gnn-card")
    queries.register_gnn_model("gnn-card", queries._gnn_model(
        "gnn-card").params, queries._gnn_model("gnn-card").features.to(cuda),
        device=cuda)
    g = GraphMatrix.from_dense(torch.from_numpy(d).to(cuda), tile_dim=t,
                               device=cuda, backend="b2sr_cuda")
    before = spmm.spmm_bbf.launches
    got = queries.gnn_infer(g, [1, 2, 3], "gnn-card").logits
    assert spmm.spmm_bbf.launches == before + 1
    want = queries.gnn_infer(g.with_backend("csr"), [1, 2, 3],
                             "gnn-card").logits
    torch.testing.assert_close(got, want, rtol=0, atol=ATOL)
