"""PyTorch port vs the JAX reference: the LM family (block masks and
block-sparse attention, RMSNorm, RoPE, the attentions, the MoE FFN, the
transformer at the five reduced configs, prefill/decode/generate, the
LM train steps, the token streams and the two launchers).

Everything runs on the CPU at the reduced configs (2 layers, d 64).
Every model is built from the reference's ``init_params`` (seed 0,
numpy, through ``convert.lm_state_from_reference``) and fed the same
numpy tokens. Each reference result is computed once per module
(``functools.lru_cache``). Tolerances:

  - the block pattern, its B2SR and the block lists equal;
  - ``block_sparse_attention`` within ``2e-5``;
  - RMSNorm, RoPE, ``gqa_attention``, ``chunked_causal_attention`` and
    ``moe_ffn`` (y and aux) within ``1e-5``; the chunked path with
    bfloat16 probabilities and RMSNorm of a bfloat16 input within
    ``1e-2``;
  - logits and losses within ``rtol 1e-4`` (and ``atol 1e-4`` of the
    values' scale); every gradient within ``1e-4`` of its max |g|; the
    bfloat16 model's logits within ``2e-2`` of their max |logit|;
  - parameters after two SGD steps, AdamW's losses and gradient norms
    within ``1e-5``;
  - tokens, the greedy continuation and the streams' batches equal.

The ``cuda`` test holds a train step and a decode step on the card
against the same steps on the CPU and skips here.
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
    from repro.core import blockmask as rbm
    from repro.data import synthetic as rsyn
    from repro.models import moe as rmoe
    from repro.models import transformer as RT
    from repro.training import optimizer as ropt
    from repro.training import train_steps as rsteps
except ImportError:                      # a card's machine without JAX
    jnp = None

from repro_torch import configs, convert  # noqa: E402
from repro_torch import nn as pnn  # noqa: E402
from repro_torch.core import blockmask  # noqa: E402
from repro_torch.core.words import to_numpy_u32  # noqa: E402
from repro_torch.data import synthetic  # noqa: E402
from repro_torch.launch import serve as launch_serve  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.training import optimizer as opt  # noqa: E402
from repro_torch.training import train_steps  # noqa: E402

needs_reference = pytest.mark.skipif(
    jnp is None, reason="the JAX reference package needs jax")

LM_ARCHS = ("phi4-mini-3.8b", "gemma-7b", "minitron-4b", "qwen3-moe-30b-a3b",
            "arctic-480b")
MOE_ARCHS = ("qwen3-moe-30b-a3b", "arctic-480b")
TOL = 1e-5
RTOL = 1e-4
GRAD_REL = 1e-4
BF16_TOL = 2e-2
PROBS_BF16_TOL = 1e-2
ATTN_TOL = 2e-5
B, S = 2, 16


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def t2n(x):
    return x.detach().float().numpy()


def rcfg_of(arch, **kw):
    rcfg = rconfigs.get_reduced_config(arch)
    cfg = configs.get_reduced_config(arch)
    if "capacity_factor" in kw:
        cf = kw.pop("capacity_factor")
        rcfg = dataclasses.replace(rcfg, moe=dataclasses.replace(
            rcfg.moe, capacity_factor=cf))
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=cf))
    return dataclasses.replace(rcfg, **kw), dataclasses.replace(cfg, **kw)


@functools.lru_cache(maxsize=None)
def ref_params(arch):
    """The reference's ``init_params`` at the reduced config (seed 0)."""
    rcfg = rconfigs.get_reduced_config(arch)
    return RT.init_params(rcfg, jax.random.PRNGKey(0))


def port_model(arch, **kw):
    _, cfg = rcfg_of(arch, **kw)
    model = T.Transformer(cfg)
    model.load_state_dict(convert.lm_state_from_reference(
        cfg, np_tree(ref_params(arch)), device="cpu"))
    return model


def port_params(arch, params=None):
    cfg = configs.get_reduced_config(arch)
    return convert.lm_state_from_reference(
        cfg, np_tree(ref_params(arch) if params is None else params),
        device="cpu")


@functools.lru_cache(maxsize=None)
def tokens(arch, batch=B, seq=S, seed=0):
    """``(tokens, labels)`` as numpy, the reference's ``lm_batch``."""
    t, l = rsyn.lm_batch(rconfigs.get_reduced_config(arch), batch, seq, seed)
    return np.array(t), np.array(l)


def close_to(got, want, tol, rel=True, msg=""):
    want = np.asarray(want, np.float32)
    scale = float(np.abs(want).max()) if rel and want.size else 1.0
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=0,
                               atol=tol * max(scale, 1e-12), err_msg=msg)


# -- block masks and block-sparse attention ---------------------------------------

@needs_reference
@pytest.mark.parametrize("tile_dim", (4, 8, 32))
def test_block_lists_match_reference(tile_dim):
    """Pattern, B2SR arrays and block lists equal; at t = 32 bit 31 (the
    int32 words' sign bit) is set in many words."""
    nb = 80
    rows, cols = blockmask.local_strided_pattern(nb, window=4, stride=8)
    rrows, rcols = rbm.local_strided_pattern(nb, window=4, stride=8)
    np.testing.assert_array_equal(rows, rrows)
    np.testing.assert_array_equal(cols, rcols)
    mat, ell = blockmask.pattern_to_b2sr(rows, cols, nb, tile_dim,
                                         device="cpu")
    rmat, rell = rbm.pattern_to_b2sr(rrows, rcols, nb, tile_dim)
    np.testing.assert_array_equal(mat.tile_row_ptr.numpy(),
                                  np.asarray(rmat.tile_row_ptr))
    np.testing.assert_array_equal(to_numpy_u32(ell.bit_tiles),
                                  np.asarray(rell.bit_tiles))
    if tile_dim == 32:
        assert (to_numpy_u32(ell.bit_tiles) >> 31).any()
    for w in (nb, 7):
        np.testing.assert_array_equal(
            blockmask.block_lists_from_ell(ell, w).numpy(),
            np.asarray(rbm.block_lists_from_ell(rell, w)))


@needs_reference
@pytest.mark.parametrize("tile_dim", (4, 8))
def test_block_sparse_attention_matches_reference(tile_dim, monkeypatch):
    """``tests/test_blockmask.py``'s shapes, within 2e-5 (query blocks
    in one group, and in groups of 3 that do not divide the 8)."""
    b, s, h, hd, bs = 2, 256, 2, 16, 32
    nb = s // bs
    rows, cols = rbm.local_strided_pattern(nb, window=2, stride=3)
    _, rell = rbm.pattern_to_b2sr(rows, cols, nb, tile_dim)
    _, ell = blockmask.pattern_to_b2sr(rows, cols, nb, tile_dim,
                                       device="cpu")
    rng = np.random.default_rng(0)
    q, k, v = (rng.standard_normal((b, s, h, hd)).astype(np.float32)
               for _ in range(3))
    want = rbm.block_sparse_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        rbm.block_lists_from_ell(rell, nb), bs)
    ids = blockmask.block_lists_from_ell(ell, nb)
    for per_step in (16, 3):
        monkeypatch.setattr(blockmask, "Q_BLOCKS_PER_STEP", per_step)
        got = blockmask.block_sparse_attention(
            torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
            ids, bs)
        np.testing.assert_allclose(t2n(got), np.asarray(want), rtol=ATTN_TOL,
                                   atol=ATTN_TOL)


# -- building blocks ---------------------------------------------------------------

@needs_reference
@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
def test_rms_norm_matches_reference(dtype):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, 5, 64)).astype(np.float32)
    scale = rng.standard_normal(64).astype(np.float32) * 0.1
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    want = rnn.rms_norm({"scale": jnp.asarray(scale)},
                        jnp.asarray(x).astype(jdt), 1e-6)
    norm = pnn.RMSNorm(64, 1e-6)
    with torch.no_grad():
        norm.scale.copy_(torch.from_numpy(scale))
    got = norm(torch.from_numpy(x).to(getattr(torch, dtype)))
    assert got.dtype == getattr(torch, dtype)
    close_to(t2n(got), np.asarray(want.astype(jnp.float32)),
             TOL if dtype == "float32" else PROBS_BF16_TOL)
    assert not pnn.RMSNorm(8).scale.any()


@needs_reference
def test_rope_matches_reference():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 9, 3, 16)).astype(np.float32)
    pos = np.stack([np.arange(9), np.arange(9) + 100]).astype(np.int32)
    want = RT.rope(jnp.asarray(x), jnp.asarray(pos), 10000.0)
    got = T.rope(torch.from_numpy(x), torch.from_numpy(pos), 10000.0)
    close_to(t2n(got), want, TOL)


def qkv(s, h=4, kv=2, hd=16, seed=3):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((2, s, h, hd)).astype(np.float32),
            rng.standard_normal((2, s, kv, hd)).astype(np.float32),
            rng.standard_normal((2, s, kv, hd)).astype(np.float32))


@needs_reference
def test_gqa_attention_matches_reference():
    q, k, v = qkv(24)
    mask = np.tril(np.ones((24, 24), bool))[None, None]
    want = RT.gqa_attention(*map(jnp.asarray, (q, k, v, mask)))
    got = T.gqa_attention(*map(torch.from_numpy, (q, k, v, mask)))
    close_to(t2n(got), want, TOL)
    # a 3-d mask, as decode-time callers may give
    m3 = np.broadcast_to(mask[0], (2, 24, 24)).copy()
    close_to(t2n(T.gqa_attention(*map(torch.from_numpy, (q, k, v, m3)))),
             want, TOL)


@needs_reference
def test_attention_scores_sum_in_float32():
    """bfloat16 q and k with scores of about ±30: ``attn_scores`` equals
    the reference's einsum with ``preferred_element_type=float32``, which
    rounding the scores to bfloat16 would miss by far more than the
    tolerance; its gradients are autograd's through float32 copies,
    rounded to bfloat16."""
    rng = np.random.default_rng(5)
    q = (8 * rng.standard_normal((2, 24, 2, 3, 16))).astype(np.float32)
    k = rng.standard_normal((2, 40, 2, 16)).astype(np.float32)
    q16 = torch.from_numpy(q).bfloat16().requires_grad_()
    k16 = torch.from_numpy(k).bfloat16().requires_grad_()
    got = T.attn_scores(q16, k16)
    want = np.asarray(jnp.einsum(
        "bskgh,btkh->bkgst", jnp.asarray(q, jnp.bfloat16),
        jnp.asarray(k, jnp.bfloat16), preferred_element_type=jnp.float32)
        * (1.0 / jnp.sqrt(16).astype(jnp.float32)))
    assert got.dtype == torch.float32
    close_to(t2n(got), want, 1e-6)
    rounded = t2n(got.bfloat16())
    assert np.abs(rounded - want).max() > 1e-4 * np.abs(want).max()
    w = torch.from_numpy(rng.standard_normal(got.shape).astype(np.float32))
    grads = torch.autograd.grad((got * w).sum(), (q16, k16))
    q32, k32 = (x.detach().float().requires_grad_() for x in (q16, k16))
    wants = torch.autograd.grad((T.attn_scores(q32, k32) * w).sum(),
                                (q32, k32))
    for g, gw in zip(grads, wants):
        assert g.dtype == torch.bfloat16
        torch.testing.assert_close(g, gw.bfloat16(), rtol=0, atol=0)


@needs_reference
@pytest.mark.parametrize("probs_bf16", (False, True))
def test_chunked_attention_matches_reference(probs_bf16):
    """q blocks of 16, kv blocks of 32 over S = 96: full, partial and
    skipped kv blocks; against the reference's chunked path and its plain
    causal ``gqa_attention``."""
    q, k, v = qkv(96)
    rcfg, cfg = rcfg_of("phi4-mini-3.8b", attn_probs_bf16=probs_bf16)
    want = RT.chunked_causal_attention(*map(jnp.asarray, (q, k, v)), rcfg,
                                       q_block=16, kv_block=32)
    got = T.chunked_causal_attention(*map(torch.from_numpy, (q, k, v)), cfg,
                                     q_block=16, kv_block=32)
    close_to(t2n(got), want, PROBS_BF16_TOL if probs_bf16 else TOL)
    plain = T.gqa_attention(*map(torch.from_numpy, (q, k, v)), torch.tril(
        torch.ones((96, 96), dtype=torch.bool))[None, None])
    close_to(t2n(got), t2n(plain), PROBS_BF16_TOL if probs_bf16 else TOL)
    with pytest.raises(ValueError, match="multiple"):
        T.chunked_causal_attention(*map(torch.from_numpy, (q, k, v)), cfg,
                                   q_block=40, kv_block=32)


@needs_reference
@pytest.mark.parametrize("arch", MOE_ARCHS)
@pytest.mark.parametrize("cf", (1.25, 0.25))
def test_moe_ffn_matches_reference(arch, cf):
    """y and aux within 1e-5 of the reference's dense dispatch; at
    capacity factor 0.25 assignments drop (counted against the
    reference's own table)."""
    rcfg, cfg = rcfg_of(arch, capacity_factor=cf)
    rp = ref_params(arch)["layers"]["moe"]
    rp0 = jax.tree_util.tree_map(lambda a: a[0], rp)
    x = np.random.default_rng(4).standard_normal((2, 24, 64)).astype(
        np.float32)
    want_y, want_aux = rmoe.moe_ffn(rp0, jnp.asarray(x), rcfg)
    layer = port_model(arch, capacity_factor=cf).layers[0].moe
    with torch.no_grad():
        y, aux = layer(torch.from_numpy(x))
    close_to(t2n(y), want_y, TOL)
    close_to(float(aux), float(want_aux), TOL)
    with torch.no_grad():
        _, _, gates, experts = moe.route(
            layer, torch.from_numpy(x).reshape(-1, 64), cfg.moe)
    _, _, dropped = moe.dispatch_table(experts, gates, cfg.moe.n_experts,
                                       moe.capacity(48, cfg.moe))
    counts = np.bincount(experts.reshape(-1).numpy(),
                         minlength=cfg.moe.n_experts)
    want_drop = int(np.maximum(counts - moe.capacity(48, cfg.moe), 0).sum())
    assert int(dropped) == want_drop
    assert want_drop > 0 or cf > 1
    assert moe.capacity(48, cfg.moe) == rmoe.capacity(48, rcfg.moe)


# -- the whole model ----------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def ref_loss_and_grads(arch):
    rcfg = rconfigs.get_reduced_config(arch)
    t, l = tokens(arch)
    logits, aux = RT.forward(ref_params(arch), jnp.asarray(t), rcfg)
    (loss, _), grads = jax.jit(jax.value_and_grad(
        lambda p: RT.loss_fn(p, jnp.asarray(t), jnp.asarray(l), rcfg),
        has_aux=True))(ref_params(arch))
    return np.asarray(logits), float(aux), float(loss), np_tree(grads)


@needs_reference
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_model_matches_reference(arch):
    """Logits, aux and the loss within 1e-4; every gradient within 1e-4
    of its max |g| (``remat`` on, as in the reduced configs)."""
    cfg = configs.get_reduced_config(arch)
    want_logits, want_aux, want_loss, want_grads = ref_loss_and_grads(arch)
    t, l = tokens(arch)
    params = port_params(arch)
    model = port_model(arch)
    with torch.no_grad():
        logits, aux = model(torch.from_numpy(t))
    close_to(t2n(logits), want_logits, RTOL)
    np.testing.assert_allclose(float(aux), want_aux, rtol=RTOL, atol=1e-7)
    loss_fn = train_steps.lm_loss_fn(cfg)
    (loss, metrics), grads = train_steps.value_and_grad(
        loss_fn, params, torch.from_numpy(t), torch.from_numpy(l))
    np.testing.assert_allclose(float(loss), want_loss, rtol=RTOL)
    np.testing.assert_allclose(float(metrics["ce"] + metrics["aux"]),
                               float(loss), rtol=1e-6)
    want = convert.lm_state_from_reference(cfg, want_grads, device="cpu")
    assert set(grads) == set(want)
    for k in want:
        close_to(t2n(grads[k]), t2n(want[k]), GRAD_REL, msg=k)


@needs_reference
def test_model_bfloat16_matches_reference():
    """The compute dtype bfloat16 (float32 parameters cast at use): logits
    within 2e-2 of max |logit|, the loss within 2e-2."""
    rcfg, cfg = rcfg_of("qwen3-moe-30b-a3b", dtype="bfloat16")
    t, l = tokens("qwen3-moe-30b-a3b")
    want, _ = RT.forward(ref_params("qwen3-moe-30b-a3b"), jnp.asarray(t),
                         rcfg)
    model = port_model("qwen3-moe-30b-a3b", dtype="bfloat16")
    with torch.no_grad():
        got, _ = model(torch.from_numpy(t))
    assert got.dtype == torch.float32
    close_to(t2n(got), np.asarray(want), BF16_TOL)


@needs_reference
@pytest.mark.parametrize("probs_bf16", (False, True))
def test_chunked_path_inside_forward(probs_bf16):
    """Reduced phi4 with one layer at S = 3,072 (above the 2,048
    threshold: q blocks of 512, kv blocks of 1,024): the last position's
    logits within 1e-4, or 1e-2 with bfloat16 probabilities."""
    rcfg, cfg = rcfg_of("phi4-mini-3.8b", n_layers=1,
                        attn_probs_bf16=probs_bf16)
    rp = RT.init_params(rcfg, jax.random.PRNGKey(1))
    t = np.random.default_rng(5).integers(0, 256, (1, 3072)).astype(np.int32)
    want = jax.jit(lambda p, x: RT.forward(p, x, rcfg, last_only=True)[0])(
        rp, jnp.asarray(t))
    model = T.Transformer(cfg)
    model.load_state_dict(convert.lm_state_from_reference(
        cfg, np_tree(rp), device="cpu"))
    with torch.no_grad():
        got, _ = model(torch.from_numpy(t), last_only=True)
    assert got.shape == (1, 1, 256)
    close_to(t2n(got), np.asarray(want), PROBS_BF16_TOL if probs_bf16
             else RTOL)


# -- serving ------------------------------------------------------------------------

@needs_reference
@pytest.mark.parametrize("arch", ("phi4-mini-3.8b", "qwen3-moe-30b-a3b"))
def test_prefill_and_decode_match_reference(arch):
    """``prefill`` (logits and caches) and one ``decode_step`` from the
    prefilled cache, through the steps, against the reference's."""
    rcfg, cfg = rcfg_of(arch)
    t, _ = tokens(arch, seq=11)
    rp = ref_params(arch)
    rlog, (rk, rv) = RT.prefill(rp, jnp.asarray(t), rcfg)
    params = port_params(arch)
    logits, (pk, pv) = train_steps.lm_prefill_step(cfg)(
        params, torch.from_numpy(t))
    close_to(t2n(logits), np.asarray(rlog)[:, -1:], RTOL)
    close_to(t2n(pk), rk, TOL)
    close_to(t2n(pv), rv, TOL)
    K0, V0 = RT.init_cache(rcfg, B, 14)
    K0, V0 = K0.at[:, :, :11].set(rk), V0.at[:, :, :11].set(rv)
    nxt = np.asarray(rlog[:, -1:].argmax(-1)).astype(np.int32)
    rdec, rk2, rv2 = RT.decode_step(rp, jnp.asarray(nxt), K0, V0,
                                    jnp.int32(11), rcfg)
    ck, cv = T.init_cache(cfg, B, 14, device="cpu")
    ck[:, :, :11], cv[:, :, :11] = pk, pv
    dec, ck2, cv2 = train_steps.lm_decode_step(cfg)(
        params, torch.from_numpy(nxt), ck, cv, 11)
    assert ck2 is ck and cv2 is cv          # written in place
    close_to(t2n(dec), rdec, RTOL)
    close_to(t2n(ck), rk2, TOL)
    close_to(t2n(cv), rv2, TOL)


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_decode_matches_forward(arch):
    """``tests/test_models.py``'s parity check in the port alone: decode
    after a prefill of the first 11 tokens equals the forward's last
    position (MoE: capacity 8.0, so that nothing drops)."""
    cfg = configs.get_reduced_config(arch)
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=8.0))
    model = T.Transformer(cfg)
    pnn.reset_parameters(model, torch.Generator().manual_seed(0))
    t = synthetic.lm_batch(cfg, 2, 12, device="cpu")[0]
    with torch.no_grad():
        full, _ = model(t)
        _, (ck, cv) = T.prefill(model, t[:, :-1])
        K0, V0 = T.init_cache(cfg, 2, 12, device="cpu")
        K0[:, :, :11], V0[:, :, :11] = ck, cv
        dec, _, _ = T.decode_step(model, t[:, -1:], K0, V0, 11)
    torch.testing.assert_close(dec[:, 0], full[:, -1], rtol=2e-3, atol=2e-3)


@needs_reference
def test_cache_defaults_to_card_and_gspmd_fields_raise():
    cfg = configs.get_reduced_config("phi4-mini-3.8b")
    if torch.cuda.is_available():
        assert T.init_cache(cfg, 1, 4)[0].device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            T.init_cache(cfg, 1, 4)
    # the GSPMD fields act only on DTensors (tests/test_torch_spmd.py): on
    # plain tensors a config that sets them gives the same loss, bit for bit
    model = port_model("phi4-mini-3.8b")
    t, l = map(torch.from_numpy, tokens("phi4-mini-3.8b"))
    with torch.no_grad():
        want = T.loss_fn(model, t, l)[0]
        model.cfg = dataclasses.replace(cfg, batch_axes=("data",),
                                        tp_width=16)
        for layer in model.layers:
            layer.cfg = model.cfg
        got = T.loss_fn(model, t, l)[0]
    assert torch.equal(got, want)


@needs_reference
def test_generate_matches_reference():
    rcfg = rconfigs.get_reduced_config("phi4-mini-3.8b")
    prompt = np.asarray(tokens("phi4-mini-3.8b", batch=2, seq=6)[0])
    want = RT.generate(ref_params("phi4-mini-3.8b"), jnp.asarray(prompt),
                       n_steps=7, cfg=rcfg)
    model = port_model("phi4-mini-3.8b")
    got = T.generate(model, torch.from_numpy(prompt), n_steps=7)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.dtype == torch.int32
    g = torch.Generator().manual_seed(3)
    hot = T.generate(model, torch.from_numpy(prompt), 5, temperature=1.0,
                     generator=g)
    assert hot.shape == (2, 5) and int(hot.max()) < rcfg.vocab_size


# -- training steps ------------------------------------------------------------------

def run_ref_steps(arch, ocfg_kw, n, grad_accum=1, batch=B):
    rcfg = rconfigs.get_reduced_config(arch)
    rocfg = ropt.OptimizerConfig(**ocfg_kw)
    step = jax.jit(rsteps.lm_train_step(rcfg, rocfg, grad_accum))
    p, st, metrics = ref_params(arch), ropt.init(rocfg, ref_params(arch)), []
    for i in range(n):
        t, l = tokens(arch, batch=batch, seed=i)
        p, st, m = step(p, st, jnp.asarray(t), jnp.asarray(l))
        metrics.append({k: float(v) for k, v in m.items()})
    return np_tree(p), metrics


def run_port_steps(arch, ocfg_kw, n, grad_accum=1, batch=B):
    cfg = configs.get_reduced_config(arch)
    ocfg = opt.OptimizerConfig(**ocfg_kw)
    step = train_steps.lm_train_step(cfg, ocfg, grad_accum)
    p = port_params(arch)
    st, metrics = opt.init(ocfg, p), []
    for i in range(n):
        t, l = tokens(arch, batch=batch, seed=i)
        p, st, m = step(p, st, torch.from_numpy(t), torch.from_numpy(l))
        metrics.append({k: float(v) for k, v in m.items()})
    return p, metrics


@needs_reference
def test_sgd_steps_match_reference():
    """Two SGD steps: the parameters within 1e-5."""
    kw = dict(name="sgd", lr=1e-2, warmup_steps=1)
    rp, rm = run_ref_steps("arctic-480b", kw, 2)
    p, m = run_port_steps("arctic-480b", kw, 2)
    want = port_params("arctic-480b", rp)
    for k in want:
        close_to(t2n(p[k]), t2n(want[k]), TOL, rel=False, msg=k)
    for a, b in zip(m, rm):
        np.testing.assert_allclose(a["loss"], b["loss"], rtol=TOL)


@needs_reference
@pytest.mark.parametrize("grad_accum", (1, 2))
def test_adamw_steps_match_reference(grad_accum):
    """Two AdamW steps (``grad_accum`` 1 and 2, batch 4): the losses and
    gradient norms within 1e-5."""
    kw = dict(name="adamw", lr=1e-3, warmup_steps=1)
    _, rm = run_ref_steps("phi4-mini-3.8b", kw, 2, grad_accum, batch=4)
    _, m = run_port_steps("phi4-mini-3.8b", kw, 2, grad_accum, batch=4)
    for a, b in zip(m, rm):
        for key in ("loss", "grad_norm"):
            np.testing.assert_allclose(a[key], b[key], rtol=TOL, err_msg=key)


def test_grad_accum_averages_microbatches():
    """``grad_accum=2`` over a batch of 4 updates with the mean of the two
    microbatches' gradients: SGD's first step equals one full-batch step
    whose loss is the mean (the CE means are over equal microbatches)."""
    cfg = configs.get_reduced_config("minitron-4b")
    model = T.Transformer(cfg)
    pnn.reset_parameters(model, torch.Generator().manual_seed(1))
    params = {k: v.detach() for k, v in model.named_parameters()}
    ocfg = opt.OptimizerConfig(name="sgd", lr=1e-2, warmup_steps=1,
                               grad_clip=1e9)
    t, l = synthetic.lm_batch(cfg, 4, 8, seed=2, device="cpu")
    one = train_steps.lm_train_step(cfg, ocfg)(params, opt.init(ocfg, params),
                                               t, l)
    two = train_steps.lm_train_step(cfg, ocfg, 2)(
        params, opt.init(ocfg, params), t, l)
    np.testing.assert_allclose(float(two[2]["loss"]), float(one[2]["loss"]),
                               rtol=1e-5)
    for k in params:
        torch.testing.assert_close(two[0][k], one[0][k], rtol=1e-5,
                                   atol=1e-6)
    with pytest.raises(ValueError, match="grad_accum"):
        train_steps.lm_train_step(cfg, ocfg, 3)(params, opt.init(
            ocfg, params), t, l)


# -- data, conversion, init, registry, launchers --------------------------------------

@needs_reference
def test_lm_batch_and_token_stream_match_reference():
    rcfg = rconfigs.get_reduced_config("gemma-7b")
    cfg = configs.get_reduced_config("gemma-7b")
    for got, want in zip(synthetic.lm_batch(cfg, 3, 10, seed=4, device="cpu"),
                         rsyn.lm_batch(rcfg, 3, 10, seed=4)):
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    ps = synthetic.TokenStream(cfg, 2, 5, seed=7, device="cpu")
    rs = rsyn.TokenStream(rcfg, 2, 5, seed=7)
    for _ in range(3):
        for got, want in zip(next(ps), next(rs)):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert ps.state() == rs.state() == {"step": 3, "seed": 7}
    resumed = synthetic.TokenStream(cfg, 2, 5, device="cpu")
    resumed.restore(ps.state())
    for got, want in zip(next(resumed), next(rs)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@needs_reference
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_state_and_param_counts_match_reference(arch):
    """``lm_state_from_reference`` fills the port's module exactly (no key
    missing or left over); ``n_params`` and ``n_active_params`` equal the
    reference's at full width; the port's own initialisation has the
    reference's scales."""
    cfg = configs.get_reduced_config(arch)
    model = T.Transformer(cfg)
    model.load_state_dict(port_params(arch), strict=True)
    full, rfull = configs.get_config(arch), rconfigs.get_config(arch)
    assert full.n_params() == rfull.n_params()
    assert full.n_active_params() == rfull.n_active_params()
    pnn.reset_parameters(model, torch.Generator().manual_seed(0))
    ref = port_params(arch)
    for k, v in model.named_parameters():
        if k.endswith("scale"):
            assert not v.any(), k
        else:
            ratio = float(v.detach().std()) / float(ref[k].std())
            assert 0.8 < ratio < 1.25, (k, ratio)


def test_launch_train_and_serve_lm(tmp_path):
    out = launch_train.main(["--arch", "phi4-mini-3.8b", "--device", "cpu",
                             "--steps", "3", "--batch", "2", "--seq", "16",
                             "--ckpt-dir", str(tmp_path), "--ckpt-every",
                             "2"])
    assert out["final_step"] == 3 and len(out["losses"]) == 3
    assert all(math.isfinite(x) for x in out["losses"])
    # a relaunch resumes at step 2 with the stream at its third batch
    again = launch_train.main(["--arch", "phi4-mini-3.8b", "--device", "cpu",
                               "--steps", "3", "--batch", "2", "--seq", "16",
                               "--ckpt-dir", str(tmp_path)])
    assert again["losses"] == out["losses"][2:]
    res = launch_serve.main(["--device", "cpu", "--batch", "2",
                             "--prompt-len", "8", "--gen", "4"])
    assert np.asarray(res["tokens"]).shape == (2, 4)
    assert res["decode_p50_ms"] > 0 and res["cache_bytes"] > 0
    with pytest.raises(SystemExit):
        launch_serve.main(["--arch", "egnn", "--device", "cpu"])


# -- on the card ---------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
def test_lm_steps_on_card_match_cpu(cuda):
    """A train step and a prefill + decode step of the reduced MoE config
    on the card against the same steps on the CPU (TF32 off)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = configs.get_reduced_config("qwen3-moe-30b-a3b")
    model = T.Transformer(cfg)
    pnn.reset_parameters(model, torch.Generator().manual_seed(0))
    params = {k: v.detach() for k, v in model.named_parameters()}
    ocfg = opt.OptimizerConfig(lr=1e-3, warmup_steps=0)
    res = {}
    for dev in ("cpu", cuda):
        p = {k: v.to(dev) for k, v in params.items()}
        t, l = synthetic.lm_batch(cfg, 2, 16, seed=1, device=dev)
        new, _, m = train_steps.lm_train_step(cfg, ocfg)(
            p, opt.init(ocfg, p), t, l)
        logits, (ck, cv) = train_steps.lm_prefill_step(cfg)(p, t)
        K, V = T.init_cache(cfg, 2, 17, device=dev)
        K[:, :, :16], V[:, :, :16] = ck, cv
        dec, _, _ = train_steps.lm_decode_step(cfg)(
            p, logits.argmax(-1), K, V, 16)
        res[str(dev)] = (new, m["loss"], dec)
    (p1, l1, d1), (p2, l2, d2) = res["cpu"], res[str(cuda)]
    torch.testing.assert_close(l2.cpu(), l1, rtol=RTOL, atol=TOL)
    torch.testing.assert_close(d2.cpu(), d1, rtol=RTOL, atol=RTOL)
    for k in p1:
        torch.testing.assert_close(p2[k].cpu(), p1[k], rtol=RTOL, atol=TOL)
