"""PyTorch port vs the JAX reference: the recsys family (DIN, its
embedding bags, config, batches, train/serve/retrieval steps and the
launcher's DIN branch) and the int8 compressed psum.

Everything runs on the CPU at ``din-smoke`` (``get_reduced_config``).
Models are built from the reference's ``init_params`` (seed 0, numpy,
through ``convert.din_state_from_reference``) and fed the same numpy
batches. Tolerances:

  - configs, batches, embedding lookups and bags (every edge case), the
    compressed psum's sums and residuals and ``topk_compress`` equal,
    bit for bit where they are floats (NaN and -inf rows included);
  - the ``sum`` bag's gradient, ``attention_pool``, the forward, the
    loss and ``score_candidates`` within ``rtol 1e-5`` and ``atol
    1e-6``; every gradient within ``1e-4`` of its max |g|;
  - three AdamW steps from a converted mid-run state: losses and
    gradient norms within ``1e-5``, parameters within ``1e-5``.

The reference's psum runs under ``jax.vmap(..., axis_name="dp")``,
op by op: one mapped axis stands for the slots, with no forced host
devices. The ``cuda`` test holds a train step and the compressed psum
over four slots of the card against the CPU and skips here.
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
    from repro.data import synthetic as rsyn
    from repro.launch.specs import DIN_SHAPE_TABLE
    from repro.models.recsys import din as rdin
    from repro.models.recsys import embedding as remb
    from repro.training import compression as rcomp
    from repro.training import optimizer as ropt
    from repro.training import train_steps as rsteps
except ImportError:                      # a card's machine without JAX
    jnp = None

from repro_torch import configs, convert  # noqa: E402
from repro_torch import nn as pnn  # noqa: E402
from repro_torch.configs.recsys import DINConfig  # noqa: E402
from repro_torch.data import synthetic  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models.recsys import embedding as emb  # noqa: E402
from repro_torch.models.recsys.din import DIN, DINBatch  # noqa: E402
from repro_torch.training import compression  # noqa: E402
from repro_torch.training import optimizer as opt  # noqa: E402
from repro_torch.training import train_steps  # noqa: E402

needs_reference = pytest.mark.skipif(
    jnp is None, reason="the JAX reference package needs jax")

RTOL, ATOL = 1e-5, 1e-6
GRAD_REL = 1e-4
STEP_TOL = 1e-5
B = 16


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def t2n(x):
    return x.detach().numpy()


def same_bits(got: np.ndarray, want: np.ndarray, msg=""):
    """Equal arrays, floats by their bits (NaN and -inf included)."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype, msg
    if got.dtype.kind == "f":
        got, want = got.view(f"i{got.itemsize}"), want.view(
            f"i{want.itemsize}")
    np.testing.assert_array_equal(got, want, err_msg=msg)


def grad_close(got, want, msg=""):
    scale = max(float(np.abs(want).max()), 1e-30)
    assert float(np.abs(got - want).max()) <= GRAD_REL * scale, msg


@functools.lru_cache(maxsize=None)
def ref_params():
    """The reference's ``init_params`` at ``din-smoke`` (seed 0)."""
    return np_tree(rdin.init_params(rconfigs.get_reduced_config("din"),
                                    jax.random.PRNGKey(0)))


def port_params(params=None):
    cfg = configs.get_reduced_config("din")
    return convert.din_state_from_reference(
        cfg, ref_params() if params is None else params, device="cpu")


def port_model():
    model = DIN(configs.get_reduced_config("din"))
    model.load_state_dict(port_params())
    return model


def both_batches(batch, seed=0):
    cfg = configs.get_reduced_config("din")
    return (rsyn.din_batch(rconfigs.get_reduced_config("din"), batch, seed),
            synthetic.din_batch(cfg, batch, seed, device="cpu"))


# -- the registry, the batches -------------------------------------------------------

@needs_reference
def test_registry_matches_reference():
    rfields = [(f.name, f.default) for f in
               dataclasses.fields(rconfigs.DINConfig)]
    assert [(f.name, f.default) for f in
            dataclasses.fields(DINConfig)] == rfields
    assert set(configs.ARCH_IDS) == set(rconfigs.ARCH_IDS)
    for get in ("get_config", "get_reduced_config"):
        assert (dataclasses.asdict(getattr(configs, get)("din"))
                == dataclasses.asdict(getattr(rconfigs, get)("din")))
    assert configs.shapes_for("din") == tuple(DIN_SHAPE_TABLE)
    assert configs.DIN_SHAPES == rconfigs.RECSYS_SHAPES
    assert isinstance(configs.get_config("din"), DINConfig)


@needs_reference
@pytest.mark.parametrize("batch", (1, 32))
@pytest.mark.parametrize("seed", (0, 7))
def test_din_batch_matches_reference(batch, seed):
    want, got = both_batches(batch, seed)
    assert isinstance(got, DINBatch) and got._fields == want._fields
    for k, w, g in zip(want._fields, want, got):
        same_bits(t2n(g), np.asarray(w), k)


# -- embedding lookups and bags -----------------------------------------------------

TABLE = np.arange(15, dtype=np.float32).reshape(5, 3) / 7 - 1
#: ids with negatives that wrap (-1, -5) and ids out of range (5, -6, 9)
IDS = np.array([3, 5, 0, -1, 4, -6, 2, -5, 9, 1, 1, 3], np.int32)
#: ids 0-1 lie before the first offset (bag -1), bag 1 is empty, bag 4's
#: last ids are beyond the bags asked for (n_bags 4 of 5 offsets)
OFFSETS = np.array([2, 5, 5, 8, 10], np.int32)
N_BAGS = 4
WEIGHTS = np.linspace(-1.5, 2.0, len(IDS)).astype(np.float32)


@needs_reference
@pytest.mark.parametrize("dtype", (np.float32, np.int32))
def test_embedding_lookup_fill_mode(dtype):
    """``jnp.take``'s fill mode: -1 and -5 wrap, 5, -6 and 9 give NaN
    rows (INT32_MIN in an int table); no error raised."""
    table = (TABLE * 7).astype(dtype)
    want = np.asarray(remb.embedding_lookup(jnp.asarray(table),
                                            jnp.asarray(IDS)))
    got = emb.embedding_lookup(torch.from_numpy(table), torch.from_numpy(IDS))
    same_bits(t2n(got), want)
    ids2 = IDS.reshape(3, 4)
    same_bits(t2n(emb.embedding_lookup(torch.from_numpy(table),
                                       torch.from_numpy(ids2))),
              np.asarray(remb.embedding_lookup(jnp.asarray(table),
                                               jnp.asarray(ids2))))


@needs_reference
@pytest.mark.parametrize("mode", ("sum", "mean", "max"))
@pytest.mark.parametrize("weighted", (False, True))
@pytest.mark.parametrize("in_range", (False, True))
def test_embedding_bag_matches_reference(mode, weighted, in_range):
    """Ids before the first offset dropped, an empty bag (0, 0, -inf), ids
    beyond the last bag dropped, weights in every mode (``mean`` still
    over the count), NaN bags from out-of-range ids."""
    ids = np.where((IDS >= -5) & (IDS < 5), IDS, 2) if in_range else IDS
    w = WEIGHTS if weighted else None
    want = np.asarray(remb.embedding_bag(
        jnp.asarray(TABLE), jnp.asarray(ids), jnp.asarray(OFFSETS), N_BAGS,
        mode, None if w is None else jnp.asarray(w)))
    got = emb.embedding_bag(
        torch.from_numpy(TABLE), torch.from_numpy(ids),
        torch.from_numpy(OFFSETS), N_BAGS, mode,
        None if w is None else torch.from_numpy(w))
    same_bits(t2n(got), want, mode)


@needs_reference
@pytest.mark.parametrize("mode", ("sum", "mean"))
def test_embedding_bag_padded_matches_reference(mode):
    """An all-padding row sums to 0 and has mean 0."""
    ids = IDS.reshape(3, 4) % 5
    mask = np.array([[1, 1, 0, 1], [0, 0, 0, 0], [1, 0, 0, 0]], bool)
    want = np.asarray(remb.embedding_bag_padded(
        jnp.asarray(TABLE), jnp.asarray(ids), jnp.asarray(mask), mode))
    got = emb.embedding_bag_padded(torch.from_numpy(TABLE),
                                   torch.from_numpy(ids),
                                   torch.from_numpy(mask), mode)
    np.testing.assert_allclose(t2n(got), want, rtol=RTOL, atol=ATOL)
    with pytest.raises(ValueError):
        emb.embedding_bag_padded(torch.from_numpy(TABLE),
                                 torch.from_numpy(ids),
                                 torch.from_numpy(mask), "max")


@needs_reference
def test_embedding_bag_sum_gradient_matches_jax():
    """Dense table gradient: repeated ids add up, wrapped ids reach their
    row, dropped and out-of-range ids reach none."""
    ids = np.where(IDS == 5, 7, IDS)        # keep one id out of range
    cot = np.random.default_rng(0).standard_normal((N_BAGS, 3)).astype(
        np.float32)

    def ref_loss(t, w):
        out = remb.embedding_bag(t, jnp.asarray(ids), jnp.asarray(OFFSETS),
                                 N_BAGS, "sum", w)
        return jnp.sum(jnp.where(jnp.isfinite(out), out, 0.0) * cot)

    rg_t, rg_w = jax.grad(ref_loss, argnums=(0, 1))(jnp.asarray(TABLE),
                                                    jnp.asarray(WEIGHTS))
    t = torch.from_numpy(TABLE.copy()).requires_grad_(True)
    w = torch.from_numpy(WEIGHTS.copy()).requires_grad_(True)
    out = emb.embedding_bag(t, torch.from_numpy(ids),
                            torch.from_numpy(OFFSETS), N_BAGS, "sum", w)
    loss = torch.sum(torch.where(torch.isfinite(out), out, 0.0)
                     * torch.from_numpy(cot))
    g_t, g_w = torch.autograd.grad(loss, [t, w])
    assert g_t.layout == torch.strided
    np.testing.assert_allclose(t2n(g_t), np.asarray(rg_t), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(t2n(g_w), np.asarray(rg_w), rtol=RTOL,
                               atol=ATOL)


# -- the model ---------------------------------------------------------------------------

@needs_reference
@pytest.mark.parametrize("length", ("one", "full"))
def test_attention_pool_matches_reference(length):
    """Every history of length 1, or all L: masked scores are zeroed
    (no softmax)."""
    rcfg = rconfigs.get_reduced_config("din")
    rng = np.random.default_rng(3)
    L, d2 = rcfg.seq_len, 2 * rcfg.embed_dim
    hist = rng.standard_normal((4, L, d2)).astype(np.float32)
    target = rng.standard_normal((4, d2)).astype(np.float32)
    n = 1 if length == "one" else L
    mask = np.arange(L)[None, :].repeat(4, 0) < n
    want = np.asarray(rdin.attention_pool(ref_params(), jnp.asarray(hist),
                                          jnp.asarray(mask),
                                          jnp.asarray(target)))
    got = port_model().attention_pool(torch.from_numpy(hist),
                                      torch.from_numpy(mask),
                                      torch.from_numpy(target))
    np.testing.assert_allclose(t2n(got), want, rtol=RTOL, atol=ATOL)


@needs_reference
def test_forward_loss_and_gradients_match_reference():
    rcfg = rconfigs.get_reduced_config("din")
    rb, pb = both_batches(B, seed=1)
    rp = ref_params()
    want = np.asarray(rdin.forward(rp, rb, rcfg))
    model = port_model()
    np.testing.assert_allclose(t2n(model(pb)), want, rtol=RTOL, atol=ATOL)
    (rloss, raux), rgrads = jax.value_and_grad(
        lambda p: rdin.loss_fn(p, rb, rcfg), has_aux=True)(rp)
    (loss, aux), grads = train_steps.value_and_grad(
        train_steps.din_loss_fn(configs.get_reduced_config("din")),
        port_params(), pb)
    np.testing.assert_allclose(float(loss), float(rloss), rtol=RTOL)
    np.testing.assert_allclose(float(aux["bce"]), float(raux["bce"]),
                               rtol=RTOL)
    want_g = port_params(np_tree(rgrads))
    assert set(grads) == set(want_g)
    for k in want_g:
        grad_close(t2n(grads[k]), t2n(want_g[k]), k)
    # a serve step is the forward without gradients
    np.testing.assert_allclose(
        t2n(train_steps.din_serve_step(configs.get_reduced_config("din"))(
            port_params(), pb)), want, rtol=RTOL, atol=ATOL)


@needs_reference
@pytest.mark.parametrize("batch", (1, 3))
@pytest.mark.parametrize("chunk", (32, 4096))
def test_score_candidates_matches_reference(batch, chunk):
    """N = 100 candidates in blocks of 32 (padded with id 0 to 128) or
    one block of N."""
    rcfg = rconfigs.get_reduced_config("din")
    rb, pb = both_batches(batch, seed=4)
    rng = np.random.default_rng(5)
    ci = rng.integers(1, rcfg.n_items, 100, dtype=np.int32)
    cc = rng.integers(1, rcfg.n_cates, 100, dtype=np.int32)
    want = np.asarray(rdin.score_candidates(ref_params(), rb, jnp.asarray(ci),
                                            jnp.asarray(cc), rcfg,
                                            chunk=chunk))
    got = port_model().score_candidates(pb, torch.from_numpy(ci),
                                        torch.from_numpy(cc), chunk=chunk)
    assert got.shape == (batch, 100)
    np.testing.assert_allclose(t2n(got), want, rtol=RTOL, atol=ATOL)
    if chunk > 100:     # the retrieval step runs the default blocks
        step = train_steps.din_retrieval_step(
            configs.get_reduced_config("din"))
        np.testing.assert_allclose(
            t2n(step(port_params(), pb, torch.from_numpy(ci),
                     torch.from_numpy(cc))), want, rtol=RTOL, atol=ATOL)


@needs_reference
def test_adamw_steps_match_reference():
    """One reference step, its parameters and AdamW state carried over,
    then three more steps in each package on the batches of seeds 1-3."""
    rcfg = rconfigs.get_reduced_config("din")
    kw = dict(name="adamw", lr=1e-3, warmup_steps=1)
    rocfg, ocfg = ropt.OptimizerConfig(**kw), opt.OptimizerConfig(**kw)
    rstep = jax.jit(rsteps.din_train_step(rcfg, rocfg))
    rp = ref_params()
    rst = ropt.init(rocfg, rp)
    rp, rst, _ = rstep(rp, rst, both_batches(B, seed=0)[0])
    p = port_params(np_tree(rp))
    st = convert.opt_state_from_reference(np_tree(rst), device="cpu",
                                          family="din")
    step = train_steps.din_train_step(configs.get_reduced_config("din"),
                                      ocfg)
    for i in range(1, 4):
        rb, pb = both_batches(B, seed=i)
        rp, rst, rm = rstep(rp, rst, rb)
        p, st, m = step(p, st, pb)
        for key in ("loss", "grad_norm", "bce", "lr"):
            np.testing.assert_allclose(float(m[key]), float(rm[key]),
                                       rtol=STEP_TOL, err_msg=key)
    assert int(st.step) == int(rst.step) == 4
    want = port_params(np_tree(rp))
    for k in want:
        np.testing.assert_allclose(t2n(p[k]), t2n(want[k]), rtol=STEP_TOL,
                                   atol=STEP_TOL, err_msg=k)


def test_launch_train_din(tmp_path):
    out = launch_train.main(["--arch", "din", "--device", "cpu", "--steps",
                             "2", "--batch", "32", "--ckpt-dir",
                             str(tmp_path), "--ckpt-every", "1"])
    assert out["final_step"] == 2 and len(out["losses"]) == 2
    assert all(math.isfinite(x) for x in out["losses"])
    assert (tmp_path / "step_00000002").is_dir()


def test_default_init_is_seeded():
    """The port's own initialisation: the tables N(0, 0.02²), the MLPs
    N(0, 1/d_in) with zero biases, from one generator."""
    cfg = configs.get_reduced_config("din")
    a, b = DIN(cfg), DIN(cfg)
    for m in (a, b):
        pnn.reset_parameters(m, torch.Generator().manual_seed(5))
    for (k, p), (_, q) in zip(a.named_parameters(), b.named_parameters()):
        assert torch.equal(p, q), k
    assert 0.015 < float(a.item_table.detach().std()) < 0.025
    assert not a.mlp.layer_0.bias.any()


# -- the compressed psum ----------------------------------------------------------------

def ref_psum(xs, errors):
    f = jax.vmap(lambda x, e: rcomp.compressed_psum(x, "dp", e),
                 axis_name="dp")
    s, e = f(jnp.asarray(xs), jnp.asarray(errors))
    return np.asarray(s), np.asarray(e)


def slot_inputs(n_slots, n=2048, seed=0):
    rng = np.random.default_rng(seed)
    xs = rng.standard_normal((n_slots, n)).astype(np.float32)
    xs[:, :7] = [0.0, -0.0, 1e-30, 3.0, -3.0, 0.5, -0.5]   # ties, zeros
    return xs


@needs_reference
@pytest.mark.parametrize("n_slots", (1, 2, 4))
def test_compressed_psum_matches_reference(n_slots):
    """Four steps of error feedback, bit for bit: every slot's sum and
    its own residual; the one-shot error below 0.1 of max |exact sum|."""
    xs = slot_inputs(n_slots)
    errs = np.zeros_like(xs)
    errs_t = [torch.zeros(xs.shape[1]) for _ in range(n_slots)]
    exact = xs.sum(0)
    for step in range(4):
        want_s, want_e = ref_psum(xs, errs)
        sums, errs_t = compression.compressed_psum(
            [torch.from_numpy(x) for x in xs], errs_t)
        for i in range(n_slots):
            same_bits(t2n(sums[i]), want_s[i], f"step {step} sum {i}")
            same_bits(t2n(errs_t[i]), want_e[i], f"step {step} error {i}")
        if step == 0:
            rel = np.abs(want_s[0] - exact).max() / np.abs(exact).max()
            assert rel < 0.1, rel
        errs = want_e
    # an all-zero input: the scale's floor keeps it finite and zero
    zs, ze = compression.compressed_psum([torch.zeros(5)] * n_slots,
                                         [torch.zeros(5)] * n_slots)
    assert not zs[0].any() and not ze[0].any()


@needs_reference
@pytest.mark.parametrize("n_slots", (1, 2, 4))
def test_compressed_psum_tree_matches_reference(n_slots):
    rng = np.random.default_rng(n_slots)
    shapes = {"a": (3, 5), "b": (7,), "c": (2, 2, 2)}
    grads = {k: rng.standard_normal((n_slots,) + s).astype(np.float32)
             for k, s in shapes.items()}
    errors = {k: 0.01 * rng.standard_normal(v.shape).astype(np.float32)
              for k, v in grads.items()}
    f = jax.vmap(lambda g, e: rcomp.compressed_psum_tree(g, "dp", e),
                 axis_name="dp")
    want_s, want_e = np_tree(f({k: jnp.asarray(v) for k, v in grads.items()},
                               {k: jnp.asarray(v) for k, v in errors.items()}))
    sums, errs = compression.compressed_psum_tree(
        [{k: torch.from_numpy(v[i]) for k, v in grads.items()}
         for i in range(n_slots)],
        [{k: torch.from_numpy(v[i]) for k, v in errors.items()}
         for i in range(n_slots)])
    for i in range(n_slots):
        assert list(sums[i]) == list(shapes)
        for k in shapes:
            same_bits(t2n(sums[i][k]), want_s[k][i], f"{k} sum {i}")
            same_bits(t2n(errs[i][k]), want_e[k][i], f"{k} error {i}")
    with pytest.raises(ValueError):
        compression.compressed_psum([torch.zeros(3)], [])


@needs_reference
@pytest.mark.parametrize("case", ("ties", "k_one", "matrix"))
def test_topk_compress_matches_reference(case):
    """Ties go to the lower index (``[1, -1, 1, 0.5]`` at k = 2 keeps
    entries 0 and 1); a ``k_frac`` that gives k = 1; a 2-d input."""
    g, k_frac = {
        "ties": (np.array([1.0, -1.0, 1.0, 0.5], np.float32), 0.5),
        "k_one": (np.array([0.2, -0.7, 0.7, 0.1, -0.3], np.float32), 0.01),
        "matrix": (np.round(np.random.default_rng(2).standard_normal(
            (16, 8)), 1).astype(np.float32), 0.1),
    }[case]
    want_k, want_r = np_tree(rcomp.topk_compress(jnp.asarray(g), k_frac))
    got_k, got_r = compression.topk_compress(torch.from_numpy(g), k_frac)
    same_bits(t2n(got_k), want_k, "kept")
    same_bits(t2n(got_r), want_r, "rest")
    if case == "ties":
        np.testing.assert_array_equal(t2n(got_k), [1, -1, 0, 0])


# -- on the card ---------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
def test_din_and_psum_on_card_match_cpu(cuda):
    """A train step, a retrieval call and the compressed psum over four
    slots of the card against the same calls on the CPU (TF32 off; the
    psum bit for bit)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = configs.get_reduced_config("din")
    model = DIN(cfg)
    pnn.reset_parameters(model, torch.Generator().manual_seed(0))
    params = {k: v.detach() for k, v in model.named_parameters()}
    ocfg = opt.OptimizerConfig(lr=1e-3, warmup_steps=0)
    res = {}
    for dev in ("cpu", cuda):
        p = {k: v.to(dev) for k, v in params.items()}
        b = synthetic.din_batch(cfg, 64, seed=1, device=dev)
        new, _, m = train_steps.din_train_step(cfg, ocfg)(
            p, opt.init(ocfg, p), b)
        one = synthetic.din_batch(cfg, 1, seed=2, device=dev)
        cands = torch.arange(300, device=dev, dtype=torch.int32)
        scores = train_steps.din_retrieval_step(cfg)(p, one, cands,
                                                     cands % cfg.n_cates)
        xs = [torch.from_numpy(x).to(dev) for x in slot_inputs(4)]
        sums, errs = compression.compressed_psum(
            xs, [torch.zeros_like(x) for x in xs])
        res[str(dev)] = (new, m["loss"], scores, sums, errs)
    (p1, l1, s1, q1, e1), (p2, l2, s2, q2, e2) = res["cpu"], res[str(cuda)]
    torch.testing.assert_close(l2.cpu(), l1, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(s2.cpu(), s1, rtol=1e-4, atol=1e-5)
    for k in p1:
        torch.testing.assert_close(p2[k].cpu(), p1[k], rtol=1e-4, atol=1e-5)
    for a, b in zip(q1 + e1, q2 + e2):
        assert torch.equal(a.view(torch.int32), b.cpu().view(torch.int32))
