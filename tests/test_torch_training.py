"""PyTorch port vs the JAX reference: GCN training.

The reference test's small setup (``tests/test_training.py``: 2 layers,
d_in 16, d_hidden 8, 4 classes, 128 nodes, ``pattern="block"``, seed 0)
goes through ``repro`` and ``repro_torch`` on the CPU from the same
seeds and, through ``convert``, the same weights and optimizer state
(``b2sr_cuda`` on a CPU graph runs the kernels' plain versions).
Tolerances:

  - generators and batch arrays equal;
  - one step's loss and gradients within ``atol 1e-5, rtol 1e-4`` of
    ``jax.value_and_grad(gcn.loss_fn)``: the aggregations sum in other
    orders;
  - ``update`` within 1e-6 on the same numpy gradients (the same float32
    operations in the same order; ``pow`` and ``cos`` may round apart);
  - a 5-step run's losses within ``rtol 1e-4``.

The checkpoint and trainer tests are the parity of the reference's
``TestCheckpoint`` and ``TestTrainerRecovery``. The tests marked
``cuda`` hold one train step on the card against ``csr`` on the card and
the gradient's ``spmm_dense`` launch against its plain version, and skip
here.
"""

from __future__ import annotations

import dataclasses
import functools
import itertools
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

try:
    import jax
    import jax.numpy as jnp
    from repro.configs.base import GNNConfig as RGNNConfig
    from repro.core import b2sr as rb2sr
    from repro.data import graphs as RG
    from repro.data.synthetic import full_graph_batch as r_full_graph_batch
    from repro.models.gnn import gcn as rgcn
    from repro.training import optimizer as ropt
    from repro.training import train_steps as rsteps
except ImportError:                      # a card's machine without JAX
    jnp = None

from repro_torch import convert  # noqa: E402
from repro_torch.configs.gnn import GNNConfig  # noqa: E402
from repro_torch.core import dispatch  # noqa: E402
from repro_torch.core.graphblas import GraphMatrix  # noqa: E402
from repro_torch.data import graphs as PG  # noqa: E402
from repro_torch.data.synthetic import full_graph_batch, rmat_batch  # noqa: E402
from repro_torch.kernels.spmm import ref as spmm_ref, spmm  # noqa: E402
from repro_torch.models.gnn.gcn import GCN, loss_fn  # noqa: E402
from repro_torch.training import checkpoint as ckpt  # noqa: E402
from repro_torch.training import optimizer as opt  # noqa: E402
from repro_torch.training import train_steps  # noqa: E402
from repro_torch.training.trainer import (SimulatedFailure,  # noqa: E402
                                          TrainerConfig, TrainState, run)

needs_reference = pytest.mark.skipif(
    jnp is None, reason="the JAX reference package needs jax")

N = 128
ATOL, RTOL = 1e-5, 1e-4
OPT_TOL = 1e-6
BACKENDS = ("b2sr", "csr", "b2sr_cuda")
CFG = GNNConfig(name="t", n_layers=2, d_hidden=8, norm="sym", d_in=16,
                n_classes=4, use_b2sr=True)


@functools.lru_cache(maxsize=None)
def ref_setup():
    """The reference's batch, weights and jitted step (adamw, lr 1e-2)."""
    rcfg = RGNNConfig(name="t", family="gcn", n_layers=2, d_hidden=8,
                      norm="sym", d_in=16, n_classes=4, use_b2sr=True)
    rbatch = r_full_graph_batch(rcfg, N, pattern="block", seed=0)
    params = rgcn.init_params(rcfg, jax.random.PRNGKey(0))
    ocfg = ropt.OptimizerConfig(name="adamw", lr=1e-2)
    step = jax.jit(rsteps.gnn_train_step(rcfg, ocfg))
    return rcfg, rbatch, params, ocfg, step


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def port_batch(backend="b2sr_cuda"):
    b = full_graph_batch(CFG, N, pattern="block", seed=0, device="cpu")
    return dataclasses.replace(b, graph=b.graph.with_backend(backend))


def port_params(params):
    return convert.gcn_state_from_reference(np_tree(params), device="cpu")


def small_setup():
    """The port's twin of the reference test's ``small_setup``."""
    params = port_params(ref_setup()[2]) if jnp is not None else {
        k: v.detach() for k, v in GCN(CFG).named_parameters()}
    ocfg = opt.OptimizerConfig(name="adamw", lr=1e-2)
    return (params, opt.init(ocfg, params),
            train_steps.gnn_train_step(CFG, ocfg), port_batch())


def assert_trees_close(got, want, atol, rtol=0.0):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].float().numpy(),
                                   want[k].float().numpy(), rtol=rtol,
                                   atol=atol, err_msg=k)


# -- generators and batches ----------------------------------------------------------

@needs_reference
@pytest.mark.parametrize("pattern", sorted(PG.PATTERNS))
def test_patterns_match_reference(pattern):
    assert set(PG.PATTERNS) == set(RG.PATTERNS)
    for n, seed in ((100, 0), (257, 3)):
        got = PG.PATTERNS[pattern](n, seed=seed)
        want = RG.PATTERNS[pattern](n, seed=seed)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)


@needs_reference
def test_partition_edges_matches_reference():
    r, c = PG.block_graph(96, seed=2)
    for shards in (1, 3, 4):
        for a, b in zip(PG.partition_edges_by_receiver_block(r, c, 96,
                                                             shards),
                        RG.partition_edges_by_receiver_block(r, c, 96,
                                                             shards)):
            np.testing.assert_array_equal(a, b)


@needs_reference
@pytest.mark.parametrize("pattern,t", (("block", 32), ("hybrid", 8)))
def test_full_graph_batch_matches_reference(pattern, t):
    """The same arrays from the same seed; the adjacency's rows are the
    receivers, its tiles those of the reference's ``coo_to_b2sr(cols,
    rows)``, and it keeps its transpose."""
    rcfg = RGNNConfig(name="t", family="gcn", n_layers=2, d_hidden=8,
                      d_in=16, n_classes=4, use_b2sr=True, tile_dim=t)
    cfg = dataclasses.replace(CFG, tile_dim=t)
    rb = r_full_graph_batch(rcfg, N, pattern=pattern, seed=5)
    pb = full_graph_batch(cfg, N, pattern=pattern, seed=5, device="cpu")
    for k in ("node_feat", "senders", "receivers", "edge_mask", "labels",
              "train_mask", "node_mask", "graph_ids", "degrees"):
        np.testing.assert_array_equal(getattr(pb, k).numpy(),
                                      np.asarray(getattr(rb, k)), err_msg=k)
    assert pb.n_graphs == rb.n_graphs == 1
    assert pb.labels.dtype == torch.int64 and pb.graph.backend == "b2sr_cuda"
    want = rb2sr.coo_to_b2sr(np.asarray(rb.receivers),
                             np.asarray(rb.senders), N, N, t)
    got = pb.graph.b2sr
    np.testing.assert_array_equal(got.tile_row_ptr.numpy(),
                                  np.asarray(want.tile_row_ptr))
    np.testing.assert_array_equal(got.tile_col_idx.numpy(),
                                  np.asarray(want.tile_col_idx))
    np.testing.assert_array_equal(
        got.bit_tiles.numpy().view(np.uint32),
        np.asarray(want.bit_tiles).reshape(got.bit_tiles.shape))
    assert pb.graph.bwd is not None
    assert full_graph_batch(cfg, N, seed=5, with_b2sr=False,
                            device="cpu").graph is None


def test_rmat_batch_is_full_graph_batch_over_rmat():
    a = rmat_batch(CFG, 200, avg_degree=6, seed=1, device="cpu")
    r, c = PG.rmat_graph(200, avg_degree=6, seed=1)
    np.testing.assert_array_equal(a.senders.numpy(), r)
    np.testing.assert_array_equal(a.receivers.numpy(), c)
    np.testing.assert_array_equal(a.degrees.numpy(),
                                  np.bincount(c, minlength=200) + 1.0)


# -- one step against jax.value_and_grad ---------------------------------------------

@needs_reference
@pytest.mark.parametrize("backend", BACKENDS + ("segment_sum",))
def test_loss_and_grads_match_reference(backend):
    rcfg, rbatch, params, _, _ = ref_setup()
    (rloss, raux), rgrads = jax.value_and_grad(
        lambda p: rgcn.loss_fn(p, rbatch, rcfg), has_aux=True)(params)
    cfg = CFG
    batch = port_batch(backend if backend in BACKENDS else "b2sr")
    if backend == "segment_sum":
        cfg = dataclasses.replace(CFG, use_b2sr=False)
    (loss, aux), grads = train_steps.value_and_grad(
        train_steps.gnn_loss_fn(cfg), port_params(params), batch)
    np.testing.assert_allclose(float(loss), float(rloss), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(float(aux["ce"]), float(raux["ce"]),
                               rtol=RTOL, atol=ATOL)
    assert_trees_close(grads, port_params(rgrads), ATOL, RTOL)
    # the module path: loss_fn over a GCN, loss.backward()
    model = GCN(cfg)
    model.load_state_dict(port_params(params))
    loss2, _ = loss_fn(model, batch)
    loss2.backward()
    assert_trees_close({k: p.grad for k, p in model.named_parameters()},
                       grads, 0.0)


def test_loss_fn_masks_and_takes_graph_level_batches():
    batch = port_batch()
    params = (port_params(ref_setup()[2]) if jnp is not None else
              {k: v.detach() for k, v in GCN(CFG).named_parameters()})
    logits = train_steps.gnn_infer_step(CFG)(params, batch)
    assert tuple(logits.shape) == (N, CFG.n_classes)
    per = torch.logsumexp(logits, -1) - logits[torch.arange(N), batch.labels]
    loss, _ = train_steps.gnn_loss_fn(CFG)(params, batch)
    torch.testing.assert_close(loss, per[batch.train_mask].mean())
    empty, _ = train_steps.gnn_loss_fn(CFG)(params, dataclasses.replace(
        batch, train_mask=torch.zeros(N, dtype=torch.bool)))
    assert float(empty) == 0.0                   # divided by max(0, 1)
    # graph level: the mean over graphs of logsumexp - gold of the
    # per-graph mean of the logits, as the reference's branch
    gids = torch.arange(N) * 3 // N
    glabels = torch.tensor([1, 3, 0])
    graphs = dataclasses.replace(batch, n_graphs=3, graph_ids=gids,
                                 labels=glabels)
    gloss, _ = train_steps.gnn_loss_fn(CFG)(params, graphs)
    pooled = torch.stack([logits[gids == g].mean(0) for g in range(3)])
    torch.testing.assert_close(gloss, (torch.logsumexp(pooled, -1) - pooled[
        torch.arange(3), glabels]).mean())
    if jnp is not None:
        rcfg, rbatch, rparams, _, _ = ref_setup()
        rloss, _ = rgcn.loss_fn(rparams, rbatch.replace(
            n_graphs=3, graph_ids=jnp.asarray(gids.numpy(), jnp.int32),
            labels=jnp.asarray(glabels.numpy(), jnp.int32)), rcfg)
        np.testing.assert_allclose(float(gloss), float(rloss), rtol=RTOL,
                                   atol=ATOL)
    # the other families build their steps; an unknown one still raises
    assert callable(train_steps.gnn_train_step(
        dataclasses.replace(CFG, family="gatedgcn"), opt.OptimizerConfig()))
    with pytest.raises(NotImplementedError, match="graphsage"):
        train_steps.gnn_train_step(dataclasses.replace(CFG,
                                                       family="graphsage"),
                                   opt.OptimizerConfig())


# -- the optimizer ------------------------------------------------------------------

@needs_reference
@pytest.mark.parametrize("name,moments", itertools.product(
    ("adamw", "sgd"), ("float32", "bfloat16")))
def test_update_matches_reference(name, moments):
    """Three updates on the same numpy gradients (one large enough to be
    clipped), from the same parameters and state."""
    kw = dict(name=name, lr=3e-2, moment_dtype=moments, warmup_steps=2,
              total_steps=6, weight_decay=0.05)
    rcfg, ocfg = ropt.OptimizerConfig(**kw), opt.OptimizerConfig(**kw)
    params = ref_setup()[2]
    rstate = ropt.init(rcfg, params)
    pparams = port_params(params)
    pstate = opt.init(ocfg, pparams)
    rng = np.random.default_rng(7)
    for scale in (0.05, 3.0, 0.2):
        rgrads = jax.tree_util.tree_map(
            lambda p: jnp.asarray(scale * rng.standard_normal(p.shape),
                                  jnp.float32), params)
        params, rstate, rm = ropt.update(rcfg, rgrads, rstate, params)
        pparams, pstate, pm = opt.update(ocfg, port_params(rgrads), pstate,
                                         pparams)
        assert_trees_close(pparams, port_params(params), OPT_TOL)
        for got, want in ((pstate.m, rstate.m), (pstate.v, rstate.v)):
            if want is None:
                assert got is None
                continue
            conv = convert.opt_state_from_reference(
                (rstate.step, np_tree(want), None), device="cpu").m
            assert all(v.dtype == getattr(torch, moments)
                       for v in got.values())
            assert_trees_close(got, conv, OPT_TOL)
        assert int(pstate.step) == int(rstate.step)
        for k in ("lr", "grad_norm"):
            np.testing.assert_allclose(float(pm[k]), float(rm[k]),
                                       rtol=OPT_TOL, atol=OPT_TOL)


@needs_reference
def test_lr_schedule_matches_reference():
    cfg = opt.OptimizerConfig(lr=5e-3, warmup_steps=10, total_steps=50)
    rcfg = ropt.OptimizerConfig(lr=5e-3, warmup_steps=10, total_steps=50)
    for s in (0, 1, 10, 50, 70):
        got = opt.lr_at(cfg, torch.tensor(s, dtype=torch.int32))
        want = ropt.lr_at(rcfg, jnp.asarray(s, jnp.int32))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got), float(want), rtol=OPT_TOL,
                                   atol=1e-12)
    assert float(opt.lr_at(cfg, torch.tensor(0))) == 0.0
    np.testing.assert_allclose(float(opt.lr_at(cfg, torch.tensor(50))),
                               5e-4, rtol=1e-6)


@needs_reference
def test_five_steps_and_a_resume_match_reference():
    """Five train steps' losses, then a resume from the reference's state
    after five steps (``opt_state_from_reference``): one more step each."""
    _, rbatch, params, _, rstep = ref_setup()
    p, ostate, step, batch = small_setup()
    rstate = ropt.init(ropt.OptimizerConfig(name="adamw", lr=1e-2), params)
    for _ in range(5):
        params, rstate, rm = rstep(params, rstate, rbatch)
        p, ostate, pm = step(p, ostate, batch)
        np.testing.assert_allclose(float(pm["loss"]), float(rm["loss"]),
                                   rtol=RTOL)
    p = port_params(params)
    ostate = convert.opt_state_from_reference(
        (np.asarray(rstate.step), np_tree(rstate.m), np_tree(rstate.v)),
        device="cpu")
    assert int(ostate.step) == 5
    params, rstate, rm = rstep(params, rstate, rbatch)
    p, ostate, pm = step(p, ostate, batch)
    np.testing.assert_allclose(float(pm["loss"]), float(rm["loss"]),
                               rtol=RTOL)
    assert_trees_close(p, port_params(params), ATOL, RTOL)


# -- checkpoints and the loop (the reference's TestCheckpoint and
#    TestTrainerRecovery) -------------------------------------------------------------

class TestCheckpoint:
    def test_roundtrip(self, tmp_path):
        params, _, _, _ = small_setup()
        ostate = opt.init(opt.OptimizerConfig(moment_dtype="bfloat16"),
                          params)
        ostate = ostate._replace(m={k: torch.randn(v.shape).to(v.dtype)
                                    for k, v in ostate.m.items()})
        tree = {"params": params, "opt": ostate}
        ckpt.save(str(tmp_path), 7, tree, extra={"data": {"seed": 3}})
        assert ckpt.latest_step(str(tmp_path)) == 7
        assert sorted(os.listdir(tmp_path / "step_00000007")) == [
            "manifest.json", "shard_0.ckpt"]
        restored, extra = ckpt.restore(str(tmp_path), 7, tree, device="cpu")
        assert isinstance(restored["opt"], opt.OptState)
        for (k, a), (k2, b) in zip(ckpt._items(tree), ckpt._items(restored)):
            assert k == k2 and a.dtype == b.dtype and a.shape == b.shape
            assert torch.equal(a, b), k
        assert restored["opt"].step.dtype == torch.int32
        assert extra == {"data": {"seed": 3}}
        with pytest.raises(ValueError, match="missing"):
            ckpt.restore(str(tmp_path), 7, {"other": params}, device="cpu")

    def test_torn_write_invisible(self, tmp_path):
        params, _, _, _ = small_setup()
        ckpt.save(str(tmp_path), 1, {"p": params})
        # a crash mid-write: a tmp dir without manifest
        os.makedirs(tmp_path / "step_00000002.tmp")
        (tmp_path / "step_00000002.tmp" / "shard_0.ckpt").write_bytes(b"junk")
        # and a renamed dir missing its manifest
        os.makedirs(tmp_path / "step_00000003")
        assert ckpt.latest_step(str(tmp_path)) == 1

    def test_gc_keeps_newest(self, tmp_path):
        params, _, _, _ = small_setup()
        for s in range(6):
            ckpt.save(str(tmp_path), s, {"p": params}, keep=2)
        assert ckpt.all_steps(str(tmp_path)) == [4, 5]


class TestTrainerRecovery:
    def test_restart_matches_uninterrupted(self, tmp_path):
        params, ostate, step, batch = small_setup()

        def data():
            return itertools.repeat((batch,))

        ref = run(TrainerConfig(total_steps=8, ckpt_every=100, log_every=0),
                  step, TrainState(params, ostate), data())
        d = str(tmp_path)
        with pytest.raises(SimulatedFailure):
            run(TrainerConfig(total_steps=8, ckpt_every=3, ckpt_dir=d,
                              log_every=0, fail_at_step=5),
                step, TrainState(params, ostate), data())
        assert ckpt.latest_step(d) == 3
        out = run(TrainerConfig(total_steps=8, ckpt_every=3, ckpt_dir=d,
                                log_every=0),
                  step, TrainState(params, ostate), data())
        assert out["final_step"] == 8 and len(out["losses"]) == 5
        assert out["losses"] == ref["losses"][3:]
        for k, v in ref["state"].params.items():
            assert torch.equal(out["state"].params[k], v), k
        assert int(out["state"].opt_state.step) == 8

    def test_straggler_counter(self):
        params, ostate, step, batch = small_setup()
        out = run(TrainerConfig(total_steps=3, log_every=0,
                                step_deadline_s=1e-9),
                  step, TrainState(params, ostate),
                  itertools.repeat((batch,)))
        assert out["stragglers"] == 3

    def test_non_finite_loss_stops(self):
        params, ostate, step, batch = small_setup()
        bad = dataclasses.replace(batch, node_feat=torch.full_like(
            batch.node_feat, float("nan")))
        with pytest.raises(FloatingPointError, match="step 0"):
            run(TrainerConfig(total_steps=2, log_every=0), step,
                TrainState(params, ostate), itertools.repeat((bad,)))


# -- the dense row's gradient without a stored transpose -----------------------------

def test_dense_grad_without_stored_transpose():
    """A 2-layer GCN on a 100-node dot graph (t = 8) over a graph built
    with ``with_transpose=False``: ``b2sr_cuda``'s gradient equals
    ``b2sr``'s and ``csr``'s (it raised before Aᵀ was built on demand),
    and Aᵀ and its work items are built once and kept with the graph."""
    n, t = 100, 8
    r, c = PG.dot_graph(n, 0.05, seed=1)
    cfg = dataclasses.replace(CFG, d_in=6, tile_dim=t)
    feat = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (n, 6)).astype(np.float32))
    torch.manual_seed(0)
    state = GCN(cfg).state_dict()
    grads = {}
    for with_t, backend in itertools.product((False, True), BACKENDS):
        g = GraphMatrix.from_coo(c, r, n, n, t, with_transpose=with_t,
                                 backend=backend, device="cpu")
        batch = full_graph_batch(cfg, n, generator=lambda *_a, **_k: (r, c),
                                 device="cpu")
        batch = dataclasses.replace(batch, node_feat=feat, graph=g)
        model = GCN(cfg)
        model.load_state_dict(state)
        for _ in range(2):                # the second walks the kept Aᵀ
            model.zero_grad()
            model(batch).sum().backward()
        grads[with_t, backend] = model.layers[0].weight.grad.clone()
        if backend == "b2sr_cuda" and not with_t:
            gt = g.fwd.cache["transpose"]
            assert gt.n_rows == n and gt.bwd is None
            assert any(k[0] == "work_items" for k in gt.fwd.cache)
            dense = torch.zeros(n, n)
            dense[torch.from_numpy(r), torch.from_numpy(c)] = 1.0
            y = torch.randn(n, 3)
            torch.testing.assert_close(
                spmm_ref.spmm_dense(gt.b2sr, y), dense @ y, rtol=0,
                atol=1e-5)
    want = grads[True, "csr"]
    for key, got in grads.items():
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5,
                                   msg=str(key))


def test_dispatch_counts_resolves():
    batch = port_batch("b2sr")
    before = dispatch.stats["resolves"]
    params = {k: v.detach() for k, v in GCN(CFG).named_parameters()}
    train_steps.gnn_infer_step(CFG)(params, batch)
    assert dispatch.stats["resolves"] - before == CFG.n_layers
    assert dispatch.last_key[:4] == ("mxm", "dense", "full", "b2sr")


# -- on the card ---------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_train_step_on_card_matches_csr(cuda):
    """One step on ``b2sr_cuda`` (two forward launches of ``spmm_dense``,
    one backward) against ``csr`` on the card."""
    b = full_graph_batch(CFG, 700, pattern="hybrid", seed=4, device=cuda)
    torch.manual_seed(0)
    params = {k: v.detach().to(cuda) for k, v in
              GCN(CFG).named_parameters()}
    ocfg = opt.OptimizerConfig(lr=5e-3, warmup_steps=0)
    step = train_steps.gnn_train_step(CFG, ocfg)
    out = {}
    for backend in ("b2sr_cuda", "csr"):
        before = spmm.spmm_dense.launches
        out[backend] = step(params, opt.init(ocfg, params),
                            dataclasses.replace(
                                b, graph=b.graph.with_backend(backend)))
        launched = spmm.spmm_dense.launches - before
        assert launched == (3 if backend == "b2sr_cuda" else 0)
    (p1, _, m1), (p2, _, m2) = out["b2sr_cuda"], out["csr"]
    torch.testing.assert_close(m1["loss"], m2["loss"], rtol=RTOL, atol=ATOL)
    for k in p1:
        torch.testing.assert_close(p1[k], p2[k], rtol=RTOL, atol=ATOL)


@pytest.mark.cuda
@pytest.mark.parametrize("with_transpose", (True, False))
def test_backward_launch_matches_plain_on_card(cuda, with_transpose):
    """The gradient's ``spmm_dense`` launch over Aᵀ equals the plain
    version's Aᵀ·dY within 1e-5·(Aᵀ·|dY|)."""
    n, t = 900, 32
    r, c = PG.rmat_graph(n, avg_degree=10, seed=6, symmetric=False)
    g = GraphMatrix.from_coo(r, c, n, n, t, with_transpose=with_transpose,
                             backend="b2sr_cuda", device=cuda)
    x = torch.randn(n, 16, device=cuda, requires_grad=True)
    w = torch.randn(n, 16, device=cuda)
    before = spmm.spmm_dense.launches
    (g.mxm(x) * w).sum().backward()
    assert spmm.spmm_dense.launches == before + 2
    mt = (g.transposed() if with_transpose
          else g.fwd.cache["transpose"]).b2sr
    want = spmm_ref.spmm_dense(mt, w).double()
    bound = 1e-5 * spmm_ref.spmm_dense(mt, w.abs()).double()
    assert bool(((x.grad.double() - want).abs() <= bound).all())
