"""PyTorch port vs the JAX reference: the GatedGCN, EGNN and GraphCast
families, the GCN's graph-level loss, the shared layers, the sampler,
the batches, Algorithm 1's profiler, the call-time sharded SpMM, the
registry and the training launcher.

Everything runs on the CPU at the reduced configs (2 layers, d 16; the
GraphCast smoke config d 32 at mesh refinement 1). Every model is built
from the reference's ``init_params`` (numpy, through
``convert.gnn_state_from_reference``) and fed the reference's batches
(the port's generators, whose arrays are checked equal first).
Tolerances:

  - arrays of the sampler, the batches and the mesh equal; the
    profiler's floats equal;
  - forwards and losses within ``atol 1e-5, rtol 1e-4`` of the
    reference's (segment sums add in other orders);
  - gradients within ``1e-4`` of each tensor's max |g| against
    ``jax.value_and_grad``;
  - GatedGCN's receiver-partitioned aggregation on 4- and 8-slot CPU
    meshes within ``rtol, atol 2e-4`` of the reference's dense forward
    (``tests/test_shardmap_agg.py``'s tolerance), with bfloat16
    messages within ``2e-2``; ``remat`` bit for bit against no remat;
  - ``spmm_b2sr_shardmap`` bit for bit against the unsharded row.

The ``cuda`` test holds a GatedGCN train step on the card against the
same step on the CPU and skips here.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

try:
    import jax
    import jax.numpy as jnp
    from repro import configs as rconfigs
    from repro import nn as rnn
    from repro.core import b2sr as rb2sr
    from repro.core import sampling as rsampling
    from repro.data import neighbor_sampler as rsampler
    from repro.data import synthetic as rsyn
    from repro.models.gnn import common as rcommon
    from repro.models.gnn import egnn as regnn
    from repro.models.gnn import gatedgcn as rgatedgcn
    from repro.models.gnn import gcn as rgcn
    from repro.models.gnn import graphcast as rgraphcast
    from repro.training import optimizer as ropt
    from repro.training import train_steps as rsteps
except ImportError:                      # a card's machine without JAX
    jnp = None

from repro_torch import configs, convert  # noqa: E402
from repro_torch import nn as pnn  # noqa: E402
from repro_torch.core import sampling  # noqa: E402
from repro_torch.core.graphblas import GraphMatrix  # noqa: E402
from repro_torch.core.mesh import make_mesh  # noqa: E402
from repro_torch.core.ops_sharded import spmm_b2sr_shardmap  # noqa: E402
from repro_torch.data import graphs as PG  # noqa: E402
from repro_torch.data import neighbor_sampler, synthetic  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models.gnn import common, egnn, gatedgcn  # noqa: E402
from repro_torch.models.gnn import graphcast  # noqa: E402
from repro_torch.training import optimizer as opt  # noqa: E402
from repro_torch.training import train_steps  # noqa: E402

needs_reference = pytest.mark.skipif(
    jnp is None, reason="the JAX reference package needs jax")

ATOL, RTOL = 1e-5, 1e-4
GRAD_REL = 1e-4
SHARD_TOL = 2e-4
BF16_TOL = 2e-2
N = 96
N_GRID = 64
FAMILIES = {"gatedgcn": (gatedgcn.GatedGCN, gatedgcn.loss_fn),
            "egnn": (egnn.EGNN, egnn.loss_fn)}


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def rmod(family):
    return {"gcn": rgcn, "gatedgcn": rgatedgcn, "egnn": regnn,
            "graphcast": rgraphcast}[family]


@functools.lru_cache(maxsize=None)
def ref_params(arch):
    """The reference's reduced config and ``init_params`` (seed 0)."""
    rcfg = rconfigs.get_reduced_config(arch)
    return rcfg, rmod(rcfg.family).init_params(rcfg, jax.random.PRNGKey(0))


def port_state(arch, params=None):
    rcfg, rp = ref_params(arch)
    cfg = configs.get_reduced_config(arch)
    return convert.gnn_state_from_reference(
        cfg, np_tree(rp if params is None else params), device="cpu")


def port_model(arch, **kw):
    cfg = configs.get_reduced_config(arch)
    cls = FAMILIES[cfg.family][0]
    model = cls(dataclasses.replace(cfg, **kw))
    model.load_state_dict(port_state(arch))
    return model


@functools.lru_cache(maxsize=None)
def batches(arch, level):
    """``(reference batch, port batch)``: node level a full block graph of
    ``N`` nodes with coordinates, graph level a molecule batch of 6."""
    rcfg, cfg = ref_params(arch)[0], configs.get_reduced_config(arch)
    if level == "node":
        rb = rsyn.full_graph_batch(rcfg, N, pattern="block", seed=1,
                                   with_b2sr=False, coords=True)
        pb = synthetic.full_graph_batch(cfg, N, pattern="block", seed=1,
                                        with_b2sr=False, coords=True,
                                        device="cpu")
    else:
        rb = rsyn.molecule_batch(rcfg, 6, nodes_per=10, edges_per=20,
                                 seed=2)
        pb = synthetic.molecule_batch(cfg, 6, nodes_per=10, edges_per=20,
                                      seed=2, device="cpu")
    return rb, pb


def t2n(x):
    return x.detach().float().numpy()


def assert_grads_close(got, want):
    assert set(got) == set(want)
    for k in want:
        w = t2n(want[k])
        scale = float(np.abs(w).max()) if w.size else 0.0
        np.testing.assert_allclose(t2n(got[k]), w, rtol=0,
                                   atol=GRAD_REL * max(scale, 1e-12),
                                   err_msg=k)


# -- nn ------------------------------------------------------------------------------

@needs_reference
def test_nn_layers_match_reference():
    rng = np.random.default_rng(0)
    p = rnn.mlp_params(jax.random.PRNGKey(1), [5, 7, 3])
    mlp = pnn.MLP([5, 7, 3], act=torch.nn.functional.silu)
    mlp.load_state_dict(convert._tree_state(np_tree(p), "", "cpu",
                                            convert._f32))
    x = rng.standard_normal((11, 5)).astype(np.float32)
    for final in (False, True):
        mlp.final_act = final
        want = rnn.mlp(p, jnp.asarray(x), act=jax.nn.silu, final_act=final)
        np.testing.assert_allclose(t2n(mlp(torch.from_numpy(x))),
                                   np.asarray(want), rtol=RTOL, atol=ATOL)
    # Dense promotes a bfloat16 input to its float32 weights, as JAX does
    xb = torch.from_numpy(x).to(torch.bfloat16)
    got = mlp.layer_0(xb)
    want = rnn.dense(p["layer_0"], jnp.asarray(x).astype(jnp.bfloat16))
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    np.testing.assert_allclose(t2n(got), np.asarray(want), rtol=RTOL,
                               atol=ATOL)
    ln = pnn.LayerNorm(5)
    lp = {"scale": rng.standard_normal(5).astype(np.float32),
          "bias": rng.standard_normal(5).astype(np.float32)}
    ln.load_state_dict({k: torch.from_numpy(v) for k, v in lp.items()})
    for dt, jdt in ((torch.float32, jnp.float32),
                    (torch.bfloat16, jnp.bfloat16)):
        got = ln(torch.from_numpy(x * 3 + 1).to(dt))
        want = rnn.layer_norm(lp, jnp.asarray(x * 3 + 1).astype(jdt))
        assert got.dtype == dt
        np.testing.assert_allclose(t2n(got), np.asarray(want, np.float32),
                                   rtol=RTOL if dt == torch.float32
                                   else 1e-2, atol=ATOL if
                                   dt == torch.float32 else 1e-2)
    assert pnn.param_count(mlp) == rnn.param_count(p) == 5 * 7 + 7 + 7 * 3 + 3
    assert pnn.param_bytes(mlp) == rnn.param_bytes(p)
    state = dict(mlp.state_dict())
    state["idx"] = torch.arange(3)
    cast = pnn.tree_cast(state, torch.bfloat16)
    assert cast["layer_0.weight"].dtype == torch.bfloat16
    assert cast["idx"].dtype == torch.int64
    assert pnn.param_bytes(cast) == rnn.param_bytes(
        rnn.tree_cast(p, jnp.bfloat16)) + 3 * 8


# -- segment aggregation, pooling, batching ------------------------------------------

def _segments():
    rng = np.random.default_rng(3)
    n, e, d = 9, 40, 4
    m = rng.standard_normal((e, d)).astype(np.float32)
    rcv = rng.integers(0, n - 2, e)                  # nodes 7, 8 get none
    mask = rng.random(e) < 0.8
    mask[rcv == 6] = False                           # node 6: all masked
    w = rng.standard_normal((n, d)).astype(np.float32)
    return m, rcv, mask, w, n


@needs_reference
@pytest.mark.parametrize("agg", ("sum", "mean", "max"))
def test_segment_agg_matches_reference(agg):
    """Forward and gradient (random floats: no ties at a maximum); masked
    edges and nodes without an edge included."""
    m, rcv, mask, w, n = _segments()

    def rloss(mm):
        out = rcommon.segment_agg(mm, jnp.asarray(rcv), n,
                                  jnp.asarray(mask), agg)
        return jnp.sum(out * w), out

    (_, rout), rgrad = jax.value_and_grad(rloss, has_aux=True)(
        jnp.asarray(m))
    mt = torch.from_numpy(m).requires_grad_(True)
    out = common.segment_agg(mt, torch.from_numpy(rcv), n,
                             torch.from_numpy(mask), agg)
    (out * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(t2n(out), np.asarray(rout), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(t2n(mt.grad), np.asarray(rgrad), rtol=RTOL,
                               atol=ATOL)
    assert not out[6:].any()
    with pytest.raises(ValueError):
        common.segment_agg(mt, torch.from_numpy(rcv), n,
                           torch.from_numpy(mask), "median")


@needs_reference
@pytest.mark.parametrize("how", ("mean", "sum"))
def test_graph_pool_matches_reference(how):
    rng = np.random.default_rng(4)
    h = rng.standard_normal((12, 3)).astype(np.float32)
    gid = np.repeat(np.arange(4), 3)
    nmask = rng.random(12) < 0.7
    nmask[9:] = False                                # graph 3 empty
    want = rcommon.graph_pool(jnp.asarray(h), jnp.asarray(gid), 4,
                              jnp.asarray(nmask), how)
    got = common.graph_pool(torch.from_numpy(h), torch.from_numpy(gid), 4,
                            torch.from_numpy(nmask), how)
    np.testing.assert_allclose(t2n(got), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


@needs_reference
def test_batch_graphs_matches_reference():
    rng = np.random.default_rng(5)
    graphs = [{"node_feat": rng.standard_normal((k, 3)).astype(np.float32),
               "senders": rng.integers(0, k, 2 * k),
               "receivers": rng.integers(0, k, 2 * k),
               "label": i % 3,
               "coords": rng.standard_normal((k, 3)).astype(np.float32)}
              for i, k in enumerate((4, 6, 5))]
    rb = rcommon.batch_graphs(graphs)
    pb = common.batch_graphs(graphs, device="cpu")
    for k in ("node_feat", "senders", "receivers", "node_mask", "edge_mask",
              "labels", "train_mask", "graph_ids", "coords"):
        np.testing.assert_array_equal(getattr(pb, k).numpy(),
                                      np.asarray(getattr(rb, k)), err_msg=k)
    assert pb.n_graphs == rb.n_graphs == 3


# -- sampler, batches, mesh ----------------------------------------------------------

def _csr(n, seed):
    rows, cols = PG.dot_graph(n, density=0.02, seed=seed)
    order = np.argsort(rows, kind="stable")
    ptr = np.zeros(n + 1, np.int64)
    np.add.at(ptr, rows[order] + 1, 1)
    return np.cumsum(ptr), cols[order]


@needs_reference
def test_sampler_matches_reference():
    ptr, col = _csr(400, 1)
    seeds = np.random.default_rng(2).choice(400, 12, replace=False)
    for fanout in ((5, 3), (4, 4, 2)):
        assert (neighbor_sampler.sampled_sizes(12, fanout)
                == rsampler.sampled_sizes(12, fanout))
        got = neighbor_sampler.sample(ptr, col, seeds, fanout, seed=7)
        want = rsampler.sample(ptr, col, seeds, fanout, seed=7)
        for f in dataclasses.fields(want):
            np.testing.assert_array_equal(getattr(got, f.name),
                                          getattr(want, f.name),
                                          err_msg=f.name)
    assert neighbor_sampler.sampled_sizes(1024, (15, 10)) == (169984, 168960)


def _assert_batch_equal(pb, rb, keys):
    for k in keys:
        np.testing.assert_array_equal(getattr(pb, k).numpy(),
                                      np.asarray(getattr(rb, k)), err_msg=k)
    assert pb.n_graphs == rb.n_graphs


@needs_reference
def test_minibatch_and_molecule_batches_match_reference():
    rcfg, cfg = ref_params("egnn")[0], configs.get_reduced_config("egnn")
    keys = ("node_feat", "senders", "receivers", "node_mask", "edge_mask",
            "labels", "train_mask", "graph_ids", "coords")
    rb = rsyn.minibatch_batch(rcfg, 3000, 16, (5, 3), seed=3, coords=True)
    pb = synthetic.minibatch_batch(cfg, 3000, 16, (5, 3), seed=3,
                                   coords=True, device="cpu")
    _assert_batch_equal(pb, rb, keys)
    # coordinates are drawn last: without them the rest is the same
    pb0 = synthetic.minibatch_batch(cfg, 3000, 16, (5, 3), seed=3,
                                    device="cpu")
    _assert_batch_equal(pb0, rb, keys[:-1])
    assert pb0.coords is None
    rb = rsyn.molecule_batch(rcfg, 5, seed=4)
    pb = synthetic.molecule_batch(cfg, 5, seed=4, device="cpu")
    _assert_batch_equal(pb, rb, keys)
    assert pb.graph is None
    rb = rsyn.full_graph_batch(rcfg, 80, pattern="hybrid", seed=6,
                               coords=True)
    pb = synthetic.full_graph_batch(cfg, 80, pattern="hybrid", seed=6,
                                    coords=True, device="cpu")
    _assert_batch_equal(pb, rb, keys + ("degrees",))


def test_b2sr_molecule_batch_masks_repeated_pairs():
    """With B2SR, each repeated (sender, receiver) pair's later copies
    leave ``edge_mask``, so the edge list is the binary adjacency."""
    cfg = dataclasses.replace(configs.get_reduced_config("gcn-cora"),
                              tile_dim=8)
    plain = synthetic.molecule_batch(cfg, 4, seed=1, with_b2sr=False,
                                     device="cpu")
    b = synthetic.molecule_batch(cfg, 4, seed=1, with_b2sr=True,
                                 device="cpu")
    pairs = b.receivers * b.node_feat.shape[0] + b.senders
    assert torch.equal(plain.senders, b.senders) and plain.edge_mask.all()
    assert int(b.edge_mask.sum()) == len(torch.unique(pairs)) < len(pairs)
    dense = torch.zeros(120, 120)
    dense[b.receivers[b.edge_mask], b.senders[b.edge_mask]] = 1
    rows, cols = (x.numpy() for x in torch.nonzero(dense, as_tuple=True))
    want = GraphMatrix.from_coo(rows, cols, 120, 120, 8, device="cpu")
    assert torch.equal(b.graph.b2sr.bit_tiles, want.b2sr.bit_tiles)


@needs_reference
def test_build_mesh_matches_reference():
    for n_grid, r in ((50, 1), (700, 2)):
        assert graphcast.mesh_sizes(r) == rgraphcast.mesh_sizes(r)
        got = graphcast.build_mesh(n_grid, r, seed=3, device="cpu")
        want = rgraphcast.build_mesh(n_grid, r, seed=3)
        assert got.n_mesh == want.n_mesh
        for f in ("g2m_senders", "g2m_receivers", "mesh_senders",
                  "mesh_receivers", "m2g_senders", "m2g_receivers"):
            np.testing.assert_array_equal(getattr(got, f).numpy(),
                                          np.asarray(getattr(want, f)))
    assert graphcast.mesh_sizes(6) == (40962, 327660)


# -- Algorithm 1 ---------------------------------------------------------------------

@needs_reference
@pytest.mark.parametrize("pattern", ("dot", "block", "road"))
def test_sample_profile_matches_reference(pattern):
    n = 1024 if pattern != "road" else 32
    rows, cols = (PG.road_graph(n) if pattern == "road"
                  else PG.PATTERNS[pattern](n, seed=2))
    n = max(int(rows.max()), int(cols.max())) + 1
    order = np.lexsort((cols, rows))
    ptr = np.zeros(n + 1, np.int64)
    np.add.at(ptr, rows[order] + 1, 1)
    ptr, col = np.cumsum(ptr), cols[order]
    for samples, seed in ((64, 0), (n + 5, 1)):
        got = sampling.sample_profile(ptr, col, n, n, samples, seed=seed)
        want = rsampling.sample_profile(ptr, col, n, n, samples, seed=seed)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
    for t in (4, 16, 32):
        m = GraphMatrix.from_coo(rows, cols, n, n, t, device="cpu").b2sr
        assert (sampling.b2sr_storage_bytes(m)
                == rb2sr.coo_to_b2sr(rows, cols, n, n, t).storage_bytes())
    assert sampling.csr_storage_bytes(n, len(col)) == rb2sr.csr_storage_bytes(
        n, len(col))


# -- the families against jax.value_and_grad ----------------------------------------

def _ref_loss(arch, rb):
    rcfg, rp = ref_params(arch)
    return jax.jit(jax.value_and_grad(
        lambda p, b: rmod(rcfg.family).loss_fn(p, b, rcfg),
        has_aux=True))(rp, rb)


@needs_reference
@pytest.mark.parametrize("arch,level", (
    ("gatedgcn", "node"), ("gatedgcn", "graph"),
    ("egnn", "node"), ("egnn", "graph")))
def test_family_matches_reference(arch, level):
    """Forward, loss and every gradient, from the reference's weights and
    batch; the module path (``loss_fn`` over the model, ``backward``)
    against the step's ``functional_call`` path."""
    rcfg, rp = ref_params(arch)
    cfg = configs.get_reduced_config(arch)
    rb, pb = batches(arch, level)
    model = port_model(arch)
    rout = jax.jit(lambda p, b: rmod(cfg.family).forward(p, b, rcfg))(rp,
                                                                      rb)
    out = model(pb)
    if arch == "egnn":
        for a, b in zip(out, rout):
            np.testing.assert_allclose(t2n(a), np.asarray(b), rtol=RTOL,
                                       atol=ATOL)
    else:
        np.testing.assert_allclose(t2n(out), np.asarray(rout), rtol=RTOL,
                                   atol=ATOL)
    (rloss, _), rgrads = _ref_loss(arch, rb)
    (loss, aux), grads = train_steps.value_and_grad(
        train_steps.gnn_loss_fn(cfg), port_state(arch), pb)
    np.testing.assert_allclose(float(loss), float(rloss), rtol=RTOL,
                               atol=ATOL)
    assert float(aux["ce"]) == float(loss)
    assert_grads_close(grads, port_state(arch, rgrads))
    loss2, _ = FAMILIES[cfg.family][1](model, pb)
    loss2.backward()
    assert float(loss2.detach()) == float(loss)
    for k, p in model.named_parameters():
        g = p.grad if p.grad is not None else torch.zeros_like(p)
        torch.testing.assert_close(g, grads[k], rtol=0, atol=0)
    infer = train_steps.gnn_infer_step(cfg)(port_state(arch), pb)
    np.testing.assert_allclose(
        t2n(infer), np.asarray(rout[0] if arch == "egnn" else rout),
        rtol=RTOL, atol=ATOL)


@needs_reference
def test_egnn_is_equivariant():
    """A rotation and a translation of the coordinates leave ``h`` and
    move ``x`` with them."""
    _, pb = batches("egnn", "node")
    model = port_model("egnn")
    q, _ = torch.linalg.qr(torch.from_numpy(
        np.random.default_rng(8).standard_normal((3, 3)).astype(np.float32)))
    shift = torch.tensor([0.5, -2.0, 1.0])
    h, x = model(pb)
    h2, x2 = model(dataclasses.replace(pb, coords=pb.coords @ q.T + shift))
    torch.testing.assert_close(h2, h, rtol=0,
                               atol=1e-4 * float(h.detach().abs().max()))
    torch.testing.assert_close(x2, x @ q.T + shift, rtol=0,
                               atol=1e-4 * float(x.detach().abs().max() + 2))
    with pytest.raises(ValueError, match="coordinates"):
        model(dataclasses.replace(pb, coords=None))


@functools.lru_cache(maxsize=None)
def graphcast_setup():
    rcfg, rp = ref_params("graphcast")
    cfg = configs.get_reduced_config("graphcast")
    rng = np.random.default_rng(9)
    feat = rng.standard_normal((N_GRID, cfg.d_in)).astype(np.float32)
    target = rng.standard_normal((N_GRID, cfg.n_classes)).astype(np.float32)
    rmesh = rgraphcast.build_mesh(N_GRID, rcfg.mesh_refinement, seed=1)
    pmesh = graphcast.build_mesh(N_GRID, cfg.mesh_refinement, seed=1,
                                 device="cpu")
    return rcfg, rp, cfg, feat, target, rmesh, pmesh


@needs_reference
def test_graphcast_matches_reference():
    rcfg, rp, cfg, feat, target, rmesh, pmesh = graphcast_setup()
    want = jax.jit(rsteps.graphcast_infer_step(rcfg, rmesh))(
        rp, jnp.asarray(feat))
    got = train_steps.graphcast_infer_step(cfg, pmesh)(
        port_state("graphcast"), torch.from_numpy(feat))
    np.testing.assert_allclose(t2n(got), np.asarray(want), rtol=RTOL,
                               atol=ATOL)
    (rloss, _), rgrads = jax.jit(jax.value_and_grad(
        lambda p: rgraphcast.loss_fn(p, jnp.asarray(feat),
                                     jnp.asarray(target), rmesh, rcfg),
        has_aux=True))(rp)
    (loss, aux), grads = train_steps.value_and_grad(
        train_steps.graphcast_loss_fn(cfg, pmesh), port_state("graphcast"),
        torch.from_numpy(feat), torch.from_numpy(target))
    np.testing.assert_allclose(float(loss), float(rloss), rtol=RTOL,
                               atol=ATOL)
    assert float(aux["mse"]) == float(loss)
    assert_grads_close(grads, port_state("graphcast", rgrads))


@needs_reference
@pytest.mark.parametrize("arch", ("gatedgcn", "egnn", "graphcast"))
def test_train_step_matches_reference(arch):
    """One step from the same weights and state: loss, gradient norm, new
    parameters (within atol 1e-5, rtol 1e-4) and the momentum carried over
    by ``opt_state_from_reference``. SGD with momentum: its update is
    linear in the gradient, so the gradients' tolerance carries over
    (AdamW's first update is ``lr·g/(|g| + eps)``, which turns a gradient
    of ~1e-8 that two summation orders round apart into updates ``lr``
    apart; ``update`` itself is held to the reference in
    ``tests/test_torch_training.py``)."""
    rcfg, rp = ref_params(arch)
    cfg = configs.get_reduced_config(arch)
    kw = dict(name="sgd", lr=1e-2, warmup_steps=1)
    rocfg, ocfg = ropt.OptimizerConfig(**kw), opt.OptimizerConfig(**kw)
    rstate = ropt.init(rocfg, rp)
    if arch == "graphcast":
        _, _, _, feat, target, rmesh, pmesh = graphcast_setup()
        rargs = (jnp.asarray(feat), jnp.asarray(target))
        args = (torch.from_numpy(feat), torch.from_numpy(target))
        rstep = rsteps.graphcast_train_step(rcfg, rocfg, rmesh)
        step = train_steps.graphcast_train_step(cfg, ocfg, pmesh)
    else:
        rb, pb = batches(arch, "graph")
        rargs, args = (rb,), (pb,)
        rstep = rsteps.gnn_train_step(rcfg, rocfg)
        step = train_steps.gnn_train_step(cfg, ocfg)
    rnew, rstate, rm = jax.jit(rstep)(rp, rstate, *rargs)
    state = convert.opt_state_from_reference(
        (0, np_tree(ropt.init(rocfg, rp).m), None), device="cpu",
        family=cfg.family)
    new, ostate, m = step(port_state(arch), state, *args)
    np.testing.assert_allclose(float(m["loss"]), float(rm["loss"]),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(float(m["grad_norm"]),
                               float(rm["grad_norm"]), rtol=RTOL)
    want = port_state(arch, rnew)
    for k in want:
        np.testing.assert_allclose(t2n(new[k]), t2n(want[k]), rtol=RTOL,
                                   atol=ATOL, err_msg=k)
    moments = convert.opt_state_from_reference(
        (rstate.step, np_tree(rstate.m), None), device="cpu",
        family=cfg.family)
    assert int(ostate.step) == int(moments.step) == 1
    assert_grads_close(ostate.m, moments.m)


# -- GatedGCN: remat, bfloat16 messages, the receiver-partitioned path ---------------

@functools.lru_cache(maxsize=None)
def sharded_setup(n_shards):
    """The reference test's data contract: block graph of 256 nodes,
    edges grouped by receiver block and padded per block."""
    n = 256
    rows, cols = PG.block_graph(n, n_blocks=8, intra_density=0.2, seed=1)
    snd, rcv, msk = PG.partition_edges_by_receiver_block(rows, cols, n,
                                                         n_shards)
    feat = np.random.default_rng(0).standard_normal((n, 8)).astype(
        np.float32)
    rb = rcommon.GraphBatch(
        node_feat=jnp.asarray(feat), senders=jnp.asarray(snd, jnp.int32),
        receivers=jnp.asarray(rcv, jnp.int32), node_mask=jnp.ones(n, bool),
        edge_mask=jnp.asarray(msk), labels=jnp.zeros(n, jnp.int32),
        train_mask=jnp.ones(n, bool), graph_ids=jnp.zeros(n, jnp.int32))
    pb = common.GraphBatch(
        node_feat=torch.from_numpy(feat), senders=torch.from_numpy(snd),
        receivers=torch.from_numpy(rcv), edge_mask=torch.from_numpy(msk),
        labels=torch.zeros(n, dtype=torch.int64),
        train_mask=torch.ones(n, dtype=torch.bool),
        node_mask=torch.ones(n, dtype=torch.bool),
        graph_ids=torch.zeros(n, dtype=torch.int64))
    rcfg, rp = ref_params("gatedgcn")
    return rb, pb, jax.jit(lambda p, b: rgatedgcn.forward(p, b, rcfg))(
        rp, rb)


@needs_reference
@pytest.mark.parametrize("slots", (4, 8))
def test_gatedgcn_sharded_matches_reference_dense(slots, monkeypatch):
    rb, pb, want = sharded_setup(slots)
    mesh = make_mesh((slots // 2, 2), ("data", "model"), ["cpu"] * slots)
    calls = []
    orig = gatedgcn.GatedGCNLayer.agg_sharded
    monkeypatch.setattr(gatedgcn.GatedGCNLayer, "agg_sharded",
                        lambda *a: calls.append(1) or orig(*a))
    model = port_model("gatedgcn", shardmap_agg_axes=("data", "model"))
    model.mesh = mesh
    np.testing.assert_allclose(t2n(model(pb)), np.asarray(want),
                               rtol=SHARD_TOL, atol=SHARD_TOL)
    assert len(calls) == 2                          # one per layer
    # the gradient flows through every slot's block
    loss, _ = gatedgcn.loss_fn(model, pb)
    loss.backward()
    grads = {k: p.grad for k, p in model.named_parameters()
             if not k.startswith("embed_e")}
    assert all(g is not None for g in grads.values())
    # a slot on another device computes over copies of the layer's
    # parameters (forced here on CPU slots): the same bits and gradients
    model.zero_grad()
    monkeypatch.setattr(gatedgcn, "_same", lambda dev, home: False)
    loss2, _ = gatedgcn.loss_fn(model, pb)
    loss2.backward()
    assert torch.equal(loss2, loss)
    for k, g in grads.items():
        assert torch.equal(dict(model.named_parameters())[k].grad, g), k
    monkeypatch.undo()
    # only one axis of the mesh named: 2 or 4 slots on "data"
    model.cfg = dataclasses.replace(model.cfg, shardmap_agg_axes=("data",
                                                                  "x"))
    assert len(model.slots(256)) == slots // 2
    # the dense path where the reference's is taken: n % slots != 0
    assert model.slots(255) is None
    model.cfg = dataclasses.replace(model.cfg, shardmap_agg_axes=("x",))
    assert model.slots(256) is None
    bf = port_model("gatedgcn", shardmap_agg_axes=("data", "model"),
                    message_dtype="bfloat16")
    bf.mesh = mesh
    np.testing.assert_allclose(t2n(bf(pb)), np.asarray(want),
                               rtol=BF16_TOL, atol=BF16_TOL)
    bad = dataclasses.replace(pb, senders=pb.senders[:-1],
                              receivers=pb.receivers[:-1],
                              edge_mask=pb.edge_mask[:-1])
    model.cfg = dataclasses.replace(model.cfg,
                                    shardmap_agg_axes=("data", "model"))
    with pytest.raises(ValueError, match="receiver"):
        model(bad)


@needs_reference
def test_gatedgcn_remat_is_bitwise():
    """``remat`` recomputes each layer in the backward: the loss and every
    gradient bit for bit against no remat, through the train step's
    ``functional_call`` (also on the sharded path)."""
    _, pb = batches("gatedgcn", "node")
    cfg = configs.get_reduced_config("gatedgcn")
    out = {}
    for remat in (False, True):
        c = dataclasses.replace(cfg, remat=remat)
        out[remat] = train_steps.value_and_grad(
            train_steps.gnn_loss_fn(c), port_state("gatedgcn"), pb)
    (l0, _), g0 = out[False]
    (l1, _), g1 = out[True]
    assert torch.equal(l0, l1)
    for k in g0:
        assert torch.equal(g0[k], g1[k]), k
    _, sb, _ = sharded_setup(4)
    mesh = make_mesh((4,), ("data",), ["cpu"] * 4)
    res = []
    for remat in (False, True):
        c = dataclasses.replace(cfg, remat=remat, shardmap_agg_axes=("data",))
        res.append(train_steps.value_and_grad(
            train_steps.gnn_loss_fn(c, mesh), port_state("gatedgcn"), sb))
    assert torch.equal(res[0][0][0], res[1][0][0])
    for k in res[0][1]:
        assert torch.equal(res[0][1][k], res[1][1][k]), k


# -- the GCN's graph-level loss ------------------------------------------------------

@functools.lru_cache(maxsize=None)
def gcn_graph_reference():
    rcfg = dataclasses.replace(rconfigs.get_reduced_config("gcn-cora"),
                               tile_dim=8)
    cfg = dataclasses.replace(configs.get_reduced_config("gcn-cora"),
                              tile_dim=8)
    rp = rgcn.init_params(rcfg, jax.random.PRNGKey(0))
    pb = synthetic.molecule_batch(cfg, 5, seed=3, with_b2sr=True,
                                  device="cpu")
    rb = rsyn.molecule_batch(rcfg, 5, seed=3).replace(
        edge_mask=jnp.asarray(pb.edge_mask.numpy()))
    (rloss, _), rgrads = jax.jit(jax.value_and_grad(
        lambda p, b: rgcn.loss_fn(p, b, rcfg), has_aux=True))(rp, rb)
    return cfg, rp, pb, rloss, rgrads


@needs_reference
@pytest.mark.parametrize("backend", ("b2sr", "b2sr_cuda", "csr",
                                     "segment_sum"))
def test_gcn_graph_level_loss_matches_reference(backend):
    """A B2SR molecule batch (repeats masked) through the GCN's
    graph-level branch on each backend, against the reference's loss and
    gradients on the same arrays and mask."""
    cfg, rp, pb, rloss, rgrads = gcn_graph_reference()
    if backend == "segment_sum":
        cfg = dataclasses.replace(cfg, use_b2sr=False)
    else:
        pb = dataclasses.replace(pb, graph=pb.graph.with_backend(backend))
    params = convert.gnn_state_from_reference(cfg, np_tree(rp), "cpu")
    (loss, _), grads = train_steps.value_and_grad(
        train_steps.gnn_loss_fn(cfg), params, pb)
    np.testing.assert_allclose(float(loss), float(rloss), rtol=RTOL,
                               atol=ATOL)
    assert_grads_close(grads, convert.gnn_state_from_reference(
        cfg, np_tree(rgrads), "cpu"))


# -- the call-time sharded SpMM ------------------------------------------------------

def test_spmm_b2sr_shardmap_is_bitwise():
    """Equal blocks of tile rows over 4 CPU slots through the sharded
    dense row, bit for bit against the unsharded row; the unsharded row
    where the even-block contract fails."""
    n, t = 256, 8
    rows, cols = PG.hybrid_graph(n, seed=3)
    g = GraphMatrix.from_coo(rows, cols, n, n, t, backend="b2sr_cuda",
                             device="cpu")
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (n, 16)).astype(np.float32))
    want = g.mxm(x)
    mesh = make_mesh((2, 2), ("data", "model"), ["cpu"] * 4)
    for axes in (("data", "model"), ("data",), ("model", "other")):
        got = spmm_b2sr_shardmap(g, x, axes, mesh)
        assert torch.equal(got, want), axes
    assert torch.equal(spmm_b2sr_shardmap(g.b2sr, x, ("data",), mesh), want)
    assert torch.equal(spmm_b2sr_shardmap(g, x, ("x",), mesh), want)
    odd = GraphMatrix.from_coo(rows % 250, cols % 250, 250, 250, t,
                               backend="b2sr_cuda", device="cpu")
    assert torch.equal(spmm_b2sr_shardmap(odd, x[:250], ("data",), mesh),
                       odd.mxm(x[:250]))
    if not torch.cuda.is_available():      # the default mesh is the card's
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            spmm_b2sr_shardmap(g, x, ("data",))


# -- registry, unknown families, the launcher ----------------------------------------

@needs_reference
def test_registry_matches_reference():
    assert set(rconfigs.ARCH_IDS) == set(configs.ARCH_IDS)
    assert configs.GNN_SHAPES == rconfigs.GNN_SHAPES
    assert configs.LM_SHAPES == rconfigs.LM_SHAPES
    assert configs.SKIPPED_CELLS == rconfigs.SKIPPED_CELLS
    for arch in configs.ARCH_IDS:
        for get in ("get_config", "get_reduced_config"):
            assert (dataclasses.asdict(getattr(configs, get)(arch))
                    == dataclasses.asdict(getattr(rconfigs, get)(arch))), arch
        assert configs.shapes_for(arch) == rconfigs.shapes_for(arch)
    for arch in ("phi4-mini-3.8b", "gemma-7b", "minitron-4b",
                 "qwen3-moe-30b-a3b", "arctic-480b"):
        assert configs.shapes_for(arch) == configs.LM_SHAPES
    with pytest.raises(KeyError):
        configs.get_config("no-such-arch")


def test_unknown_family_raises():
    cfg = dataclasses.replace(configs.get_reduced_config("egnn"),
                              family="graphsage")
    with pytest.raises(NotImplementedError, match="graphsage"):
        train_steps.gnn_train_step(cfg, opt.OptimizerConfig())
    with pytest.raises(NotImplementedError):
        train_steps.gnn_infer_step(configs.get_reduced_config("graphcast"))


@pytest.mark.parametrize("arch", ("gatedgcn", "egnn"))
def test_launch_train_main(arch, tmp_path):
    out = launch_train.main(["--arch", arch, "--device", "cpu", "--steps",
                             "3", "--nodes", "64", "--ckpt-dir",
                             str(tmp_path), "--ckpt-every", "2"])
    assert out["final_step"] == 3 and len(out["losses"]) == 3
    assert all(math.isfinite(x) for x in out["losses"])
    assert (tmp_path / "step_00000002").is_dir()
    with pytest.raises(SystemExit):
        launch_train.main(["--arch", "graphcast", "--device", "cpu"])


def test_default_init_is_seeded():
    """The port's own initialisation: N(0, 1/d_in) from a generator."""
    cfg = configs.get_config("gatedgcn")
    a, b = gatedgcn.GatedGCN(cfg), gatedgcn.GatedGCN(cfg)
    for m in (a, b):
        pnn.reset_parameters(m, torch.Generator().manual_seed(5))
    for (k, p), (_, q) in zip(a.named_parameters(), b.named_parameters()):
        assert torch.equal(p, q), k
    w = a.embed_h.weight
    assert abs(float(w.std()) * math.sqrt(cfg.d_in) - 1) < 0.05
    assert not a.embed_h.bias.any() and bool((a.layers[0].norm_h.scale
                                              == 1).all())


# -- on the card ---------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
def test_gatedgcn_step_on_card_matches_cpu(cuda):
    """One GatedGCN train step on the card against the same step on the
    CPU (float ``index_add_`` on the card adds in no fixed order)."""
    cfg = configs.get_reduced_config("gatedgcn")
    model = gatedgcn.GatedGCN(cfg)
    pnn.reset_parameters(model, torch.Generator().manual_seed(0))
    params = {k: v.detach() for k, v in model.named_parameters()}
    ocfg = opt.OptimizerConfig(lr=5e-3, warmup_steps=0)
    step = train_steps.gnn_train_step(cfg, ocfg)
    res = {}
    for dev in ("cpu", cuda):
        p = {k: v.to(dev) for k, v in params.items()}
        b = synthetic.molecule_batch(cfg, 8, seed=1, device=dev)
        res[str(dev)] = step(p, opt.init(ocfg, p), b)
    (p1, _, m1), (p2, _, m2) = res["cpu"], res[str(cuda)]
    torch.testing.assert_close(m2["loss"].cpu(), m1["loss"], rtol=RTOL,
                               atol=ATOL)
    for k in p1:
        torch.testing.assert_close(p2[k].cpu(), p1[k], rtol=RTOL, atol=ATOL)
