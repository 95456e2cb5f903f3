"""PyTorch port vs the JAX reference: the SPMD layer (sharding rules, their
DTensor placements, the expert-parallel MoE, the elastic restore and a
sharded LM step).

The rules are held against ``repro.sharding.rules`` at full size: every
parameter of the five LM configs and of DIN (the reference's shapes by
``jax.eval_shape``, the port's on ``meta``) on the 16 × 16 and
2 × 16 × 16 meshes, where each port parameter's per-device shard shape
must equal the shard of the same reference weight after the layout map
of ``convert`` (drop the stacked ``L``, transpose a projection). The
shard of a dim over axes of sizes ``k`` is ``ceil(n / k)`` rows, JAX's
padded shard. ``best_dim0_axes``, ``gnn_batch_specs`` and
``opt_state_specs`` are compared on stand-in meshes.

One test process starts 8 gloo ranks on the CPU (a (4, 2) ``("data",
"model")`` DeviceMesh; the ranks read their inputs from an ``.npz``
written here from numpy seeds and rank 0 writes its results back). Each
rank prints nothing but rank 0 prints a marker per check, and each
marker is a case of :func:`test_spawned_rank_checks`:

  - ``PLACEMENT``: every rank's local block of an ``[8, 8]`` arange under
    ``("data", "model")`` and under ``(None, "model")`` is the block JAX's
    ``NamedSharding`` gives device ``rank`` (row-major over the axes);
  - ``EP_MOE`` / ``EP_AUX`` / ``EP_GRAD``: ``moe_ffn_shardmap`` (the
    config of ``tests/test_moe_shardmap.py``, capacity factor 8.0: no
    drops) within ``2e-5`` of the dense dispatch, ``aux`` within ``2e-2``
    relative (the sharded path averages per-shard load-balance losses),
    and every gradient finite and within ``1e-4`` of its max |g| of the
    dense dispatch's (the aux estimator differs); ``EP_FALLBACK``: with
    the path switched off, the dense dispatch on replicated copies within
    ``1e-6`` of the plain one;
  - ``ELASTIC_4`` / ``ELASTIC_2x2``: ``test_elastic.py``'s tree, saved
    sharded over 8 ranks, restored over 4 and over 2 × 2, equal;
  - ``LM_STEP``: a reduced phi4-mini AdamW step with DTensor parameters,
    state and batch placed by the rules against the unsharded step: loss
    and gradient norm within ``1e-5`` relative, every gradient and first
    moment within ``1e-4`` of its max, and at most 1% of each updated
    parameter's elements off by more than ``1%`` of ``lr`` (AdamW's
    first update is about ``lr·sign(g)``, and the sign of a gradient near
    zero is noise), a bound that a step with a wrong gradient (other
    labels) must break;
  - ``LM_ONE_RANK``: on a one-rank ``(1, 1)`` mesh, the sharded
    gradients of a 3072-token batch (the chunked attention with bfloat16
    probabilities) equal the plain ones bit for bit, and with the
    vocabulary-parallel cross entropy's backward written in the
    equivalent form ``exp(x - m) / z`` they do not (its roundings, which
    the bfloat16 probabilities raise);
  - ``ATTN_SEQ``: the sequence-sharded chunked attention (heads that
    "model" does not divide, S = 3072) within ``1e-5`` of the plain one;
  - ``DECODE``: a decode step over a cache sharded over its sequence
    (split-KV): logits and both caches within ``1e-5`` of their max of
    the unsharded step's.

The sharded MoE's output and the sharded step's loss, gradient norm and
parameters are also held against the reference (``_moe_ffn_dense`` and
``lm_train_step`` on the same numpy weights) within the same
tolerances.
"""

from __future__ import annotations

import dataclasses
import functools
import math
import os
import socket
import subprocess
import sys
import textwrap
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

try:
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P
    from repro import configs as rconfigs
    from repro.models import moe as rmoe
    from repro.models import transformer as RT
    from repro.models.recsys import din as rdin
    from repro.sharding import rules as rrules
    from repro.training import optimizer as ropt
    from repro.training import train_steps as rsteps
except ImportError:                      # a card's machine without JAX
    jnp = None

from repro_torch import configs, convert  # noqa: E402
from repro_torch.models.recsys.din import DIN  # noqa: E402
from repro_torch.models.transformer import Transformer  # noqa: E402
from repro_torch.sharding import rules  # noqa: E402
from repro_torch.training import optimizer as opt  # noqa: E402

pytestmark = pytest.mark.skipif(jnp is None,
                                reason="the JAX reference package needs jax")

LM_ARCHS = ("phi4-mini-3.8b", "gemma-7b", "minitron-4b", "qwen3-moe-30b-a3b",
            "arctic-480b")
MESHES = {"16x16": (("data", "model"), (16, 16)),
          "2x16x16": (("pod", "data", "model"), (2, 16, 16))}
N_RANKS = 8


def port_mesh(name):
    names, shape = MESHES[name]
    return types.SimpleNamespace(mesh_dim_names=names, shape=shape)


def ref_mesh(name):
    names, shape = MESHES[name]
    return types.SimpleNamespace(axis_names=names, devices=np.empty(shape))


def ref_shard(shape, spec, sizes):
    """JAX's per-device shard shape of ``shape`` under ``spec``."""
    out = list(shape)
    for d, entry in enumerate(tuple(spec)):
        axes = () if entry is None else (
            (entry,) if isinstance(entry, str) else tuple(entry))
        out[d] = -(-out[d] // math.prod(sizes[a] for a in axes))
    return tuple(out)


def ref_specs_by_path(tree, specs):
    leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
    spec_leaves = jax.tree_util.tree_leaves(
        specs, is_leaf=lambda x: isinstance(x, P))
    return {rrules._path_str(p): (tuple(x.shape), s)
            for (p, x), s in zip(leaves, spec_leaves)}


def norm(spec):
    """Each entry of a spec as a tuple of axis names (``None`` → ``()``):
    JAX writes a one-axis tuple as the bare name."""
    if spec is None:
        return None
    return tuple(() if e is None else (e,) if isinstance(e, str)
                 else tuple(e) for e in tuple(spec))


def mapped(spec, stacked, transposed) -> tuple:
    """A reference spec in the port's layout: the stacked ``L`` dropped,
    a projection's two dims swapped."""
    s = tuple(spec)[1 if stacked else 0:]
    return s[::-1] if transposed else s


def ref_key(port_name):
    """``(reference path, stacked, transposed)`` of a port LM parameter."""
    parts = port_name.split(".")
    stacked = parts[0] == "layers"
    rest = parts[2:] if stacked else parts
    transposed = rest[-1] == "weight"
    if transposed:
        rest = rest[:-1]
    return "/".join((["layers"] if stacked else []) + rest), stacked, \
        transposed


# -- (a) the rules at full size ---------------------------------------------------

@functools.lru_cache(maxsize=None)
def ref_lm(arch):
    cfg = rconfigs.get_config(arch)
    shapes = jax.eval_shape(lambda: RT.init_params(cfg, jax.random.PRNGKey(0)))
    return ref_specs_by_path(shapes, rrules.lm_param_specs(cfg, shapes))


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_lm_param_shards_match_reference(arch, mesh):
    cfg = configs.get_config(arch)
    with torch.device("meta"):
        params = dict(Transformer(cfg).named_parameters())
    specs = rules.lm_param_specs(cfg, params)
    ref = ref_lm(arch)
    sizes = dict(zip(*MESHES[mesh]))
    seen = set()
    for name, p in params.items():
        path, stacked, transposed = ref_key(name)
        shape, spec = ref[path]
        seen.add(path)
        want = ref_shard(shape, spec, sizes)[1 if stacked else 0:]
        got = rules.local_shape(tuple(p.shape), port_mesh(mesh), specs[name])
        assert (got[::-1] if transposed else got) == want, (name, spec)
        assert norm(specs[name]) == norm(mapped(spec, stacked,
                                                transposed)), name
    assert seen == set(ref)


def test_din_param_specs_match_reference():
    cfg = configs.get_config("din")
    shapes = jax.eval_shape(
        lambda: rdin.init_params(rconfigs.get_config("din"),
                                 jax.random.PRNGKey(0)))
    ref = ref_specs_by_path(shapes, rrules.din_param_specs(None, shapes))
    with torch.device("meta"):
        params = dict(DIN(cfg).named_parameters())
    specs = rules.din_param_specs(cfg, params)
    sizes = dict(zip(*MESHES["16x16"]))
    for name, p in params.items():
        path = name.replace(".weight", "/w").replace(".bias", "/b") \
            .replace(".", "/")
        shape, spec = ref[path]
        want = ref_shard(shape, spec, sizes)
        got = rules.local_shape(tuple(p.shape), port_mesh("16x16"),
                                specs[name])
        assert (got[::-1] if name.endswith("weight") else got) == want
        assert norm(specs[name]) == norm(spec), name
    assert len(params) == len(ref)


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_best_dim0_axes_and_gnn_batch_specs(mesh):
    sizes_n = [1, 2, 3, 16, 48, 256, 512, 768, 2708, 4096, 10556,
               232960, 2449408, 61859328]
    for n in sizes_n:
        assert rules.best_dim0_axes(port_mesh(mesh), n) == \
            rrules.best_dim0_axes(ref_mesh(mesh), n), n
        assert rules.best_dim0_axes_static(n) == \
            rrules.best_dim0_axes_static(n)
    SDS = jax.ShapeDtypeStruct
    ref_tree = {f"a{n}": SDS((n, 3), jnp.float32) for n in sizes_n}
    ref_tree["scalar"] = SDS((), jnp.int32)
    ref_tree["none"] = None
    port_tree = {k: None if v is None else torch.empty(v.shape,
                                                       device="meta")
                 for k, v in ref_tree.items()}
    want = rrules.gnn_batch_specs(ref_mesh(mesh), ref_tree)
    got = rules.gnn_batch_specs(port_mesh(mesh), port_tree)
    for k in ref_tree:
        assert norm(got[k]) == norm(want[k]), k
    assert rules.batch_axes(port_mesh(mesh)) == \
        rrules.batch_axes(types.SimpleNamespace(axis_names=MESHES[mesh][0]))


@pytest.mark.parametrize("name", ("adamw", "sgd"))
def test_opt_state_specs_match_reference(name):
    arch = "phi4-mini-3.8b"
    rcfg = rconfigs.get_reduced_config(arch)
    shapes = jax.eval_shape(lambda: RT.init_params(rcfg,
                                                   jax.random.PRNGKey(0)))
    ocfg = ropt.OptimizerConfig(name=name)
    ospec = rrules.opt_state_specs(rrules.lm_param_specs(rcfg, shapes),
                                   jax.eval_shape(
                                       functools.partial(ropt.init, ocfg),
                                       shapes))
    cfg = configs.get_reduced_config(arch)
    with torch.device("meta"):
        params = dict(Transformer(cfg).named_parameters())
    pspecs = rules.lm_param_specs(cfg, params)
    got = rules.opt_state_specs(pspecs, opt.init(opt.OptimizerConfig(
        name=name), params))
    assert got.step == tuple(ospec.step) == ()
    assert (got.v is None) == (ospec.v is None)
    ref_m = ref_specs_by_path(shapes, ospec.m)
    assert set(got.m) == set(pspecs)
    for k, s in got.m.items():
        path, stacked, transposed = ref_key(k)
        assert s == pspecs[k]
        assert norm(s) == norm(mapped(ref_m[path][1], stacked,
                                      transposed)), k
        if got.v is not None:
            assert got.v[k] == s


def test_to_placements_follows_mesh_order():
    from torch.distributed.tensor import Replicate, Shard
    mesh = port_mesh("2x16x16")
    assert rules.to_placements(mesh, ((("pod", "data")), None)) == (
        Shard(0), Shard(0), Replicate())
    assert rules.to_placements(mesh, (None, "model")) == (
        Replicate(), Replicate(), Shard(1))
    assert rules.to_placements(mesh, ()) == (Replicate(),) * 3
    with pytest.raises(ValueError, match="axis order"):
        rules.to_placements(mesh, (("model", "data"),))


# -- (d) eight gloo ranks ------------------------------------------------------------

_WORKER = textwrap.dedent('''
    import dataclasses, os, sys, tempfile
    import numpy as np
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
    from torch.func import functional_call
    from repro_torch import configs
    from repro_torch.configs.lm import MoEConfig, TransformerConfig
    from repro_torch.launch.mesh import real_world
    from repro_torch.models import moe as moe_mod
    from repro_torch.models import transformer as T
    from repro_torch.sharding import lm as shard_lm
    from repro_torch.sharding import rules, spmd
    from repro_torch.training import checkpoint as ckpt
    from repro_torch.training import optimizer as opt
    from repro_torch.training import train_steps

    data = dict(np.load(sys.argv[1]))
    out = {}

    def rel(a, b):
        a, b = a.detach().double(), b.detach().double()
        return float((a - b).abs().max() / max(b.abs().max(), 1e-30))

    def share_off(got, want, lr):
        """The largest share, over the parameters, of elements more than
        1% of lr apart. AdamW's first update is about lr·sign(g), so two
        sound steps part only where a gradient is near zero, and a wrong
        gradient moves most elements by about 2·lr (the control below)."""
        return max(float(((got[k].double() - want[k].double()).abs()
                          > 1e-2 * lr).double().mean()) for k in want)

    def mark(name, ok, detail=""):
        if rank == 0:
            print(("" if ok else "FAILED ") + name, detail, flush=True)

    with real_world("cpu"):
        rank = dist.get_rank()
        mesh = init_device_mesh("cpu", (4, 2), mesh_dim_names=("data", "model"))

        # placement: rank r's block is JAX's device r's
        a = torch.arange(64.).reshape(8, 8)
        i, j = divmod(rank, 2)
        both = spmd.place(a, mesh, (("data", "model"), None)).to_local()
        cols = spmd.place(a, mesh, (None, "model")).to_local()
        ok = (torch.equal(both, a[rank:rank + 1])
              and torch.equal(cols, a[:, 4 * j:4 * j + 4]))
        flags = torch.tensor([float(ok)])
        dist.all_reduce(flags, op=dist.ReduceOp.MIN)
        mark("PLACEMENT", bool(flags.item()))

        # expert-parallel MoE against the dense dispatch
        cfg = TransformerConfig(
            name="t", n_layers=1, d_model=32, n_heads=4, n_kv_heads=2,
            head_dim=8, d_ff=64, vocab_size=64,
            moe=MoEConfig(n_experts=8, top_k=2, d_ff_expert=16,
                          capacity_factor=8.0),
            batch_axes=("data",), tp_width=2, dtype="float32")
        layer = moe_mod.MoE(cfg)
        layer.load_state_dict({k[4:]: torch.from_numpy(v)
                               for k, v in data.items()
                               if k.startswith("moe.")})
        x = torch.from_numpy(data["moe_x"])
        params = {k: v.detach() for k, v in layer.named_parameters()}

        def loss_of(p, xx):
            y, aux = functional_call(layer, p, (xx,))
            return (y ** 2).sum() + aux, y, aux

        leaves = {k: v.clone().requires_grad_(True) for k, v in params.items()}
        l_d, y_d, aux_d = loss_of(leaves, x)
        g_d = torch.autograd.grad(l_d, list(leaves.values()))
        specs = rules.lm_param_specs(cfg, {f"layers.0.moe.{k}": v
                                           for k, v in params.items()})
        layer_d = moe_mod.MoE(cfg)
        for k, v in params.items():
            mod, _, attr = ("." + k).rpartition(".")
            setattr(layer_d.get_submodule(mod[1:]), attr, torch.nn.Parameter(
                spmd.place(v, mesh, specs[f"layers.0.moe.{k}"])))
        xs = spmd.place(x, mesh, (("data",), None, None))
        with spmd.replicate_plain(xs):
            assert moe_mod.moe_ffn_shardmap(layer_d, xs, cfg, mesh) is not None
            y_s, aux_s = layer_d(xs)
            dparams = [dict(layer_d.named_parameters())[k] for k in params]
            g_s = torch.autograd.grad((y_s ** 2).sum() + aux_s, dparams)
        y_s, aux_s = y_s.full_tensor().detach(), aux_s.full_tensor().detach()
        y_d, aux_d = y_d.detach(), aux_d.detach()
        g_s = [g.full_tensor() for g in g_s]
        mark("EP_MOE", float((y_s - y_d).abs().max()) <= 2e-5,
             float((y_s - y_d).abs().max()))
        mark("EP_AUX", abs(float(aux_s) - float(aux_d))
             <= 2e-2 * abs(float(aux_d)), (float(aux_s), float(aux_d)))
        mark("EP_GRAD", all(bool(torch.isfinite(g).all()) for g in g_s)
             and max(rel(a, b) for a, b in zip(g_s, g_d)) <= 1e-4,
             max(rel(a, b) for a, b in zip(g_s, g_d)))
        # where the expert-parallel prerequisites fail (here: the path
        # switched off), the dense dispatch runs on replicated copies
        with spmd.replicate_plain(xs), torch.no_grad():
            y_r, aux_r = moe_mod.moe_ffn(layer_d, xs, dataclasses.replace(
                cfg, moe_shardmap_dispatch=False))
        mark("EP_FALLBACK", rel(y_r.full_tensor(), y_d) <= 1e-6
             and abs(float(aux_r.full_tensor()) - float(aux_d))
             <= 1e-6 * abs(float(aux_d)), rel(y_r.full_tensor(), y_d))
        out["moe_y_ep"] = y_s.numpy()
        out["moe_aux_ep"] = np.float32(aux_s)

        # elastic restore: saved over 8, restored over 4 and over 2 x 2
        tree = {"w": torch.arange(64, dtype=torch.float32).reshape(8, 8),
                "b": torch.ones(8), "step": torch.tensor(7, dtype=torch.int32)}
        mesh8 = init_device_mesh("cpu", (8,), mesh_dim_names=("data",))
        placed = spmd.place_tree(tree, mesh8, {"w": ("data", None),
                                               "b": ("data",), "step": ()})
        d = sys.argv[3]
        ckpt.save(d, 5, placed)
        mesh4 = DeviceMesh("cpu", [0, 1, 2, 3], mesh_dim_names=("data",))
        mesh22 = DeviceMesh("cpu", [[0, 1], [2, 3]],
                            mesh_dim_names=("data", "model"))
        for name, m, sp in (
                ("ELASTIC_4", mesh4, {"w": ("data", None), "b": ("data",),
                                      "step": ()}),
                ("ELASTIC_2x2", mesh22, {"w": ("data", "model"),
                                         "b": (("data", "model"),),
                                         "step": ()})):
            r, _ = ckpt.restore(d, 5, tree, device="cpu",
                                shardings=rules.tree_shardings(m, sp))
            ok = True
            if m.get_coordinate() is not None:
                ok = (all(torch.equal(r[k].full_tensor(), tree[k])
                          for k in tree)
                      and r["w"].device_mesh.size() == 4)
            flags = torch.tensor([float(ok)])
            dist.all_reduce(flags, op=dist.ReduceOp.MIN)
            mark(name, bool(flags.item()))

        # a reduced phi4-mini train step, sharded by the rules
        lcfg = dataclasses.replace(
            configs.get_reduced_config("phi4-mini-3.8b"),
            batch_axes=("data",), tp_width=2)
        lp = {k[3:]: torch.from_numpy(v) for k, v in data.items()
              if k.startswith("lm.")}
        tok, lab = (torch.from_numpy(data[k]) for k in ("tokens", "labels"))
        ocfg = opt.OptimizerConfig(name="adamw")
        step = train_steps.lm_train_step(lcfg, ocfg)
        p_plain, st_plain, m_plain = step(lp, opt.init(ocfg, lp), tok, lab)
        pspecs = rules.lm_param_specs(lcfg, lp)
        st = opt.init(ocfg, lp)
        dp = spmd.place_tree(lp, mesh, pspecs)
        dst = spmd.place_tree(st, mesh, rules.opt_state_specs(pspecs, st))
        bt = (("data",), None)
        dtok, dlab = spmd.place(tok, mesh, bt), spmd.place(lab, mesh, bt)
        p_sh, st_sh, m_sh = step(dp, dst, dtok, dlab)
        p_sh, st_sh = spmd.full_tree(p_sh), spmd.full_tree(st_sh)
        loss_fn = train_steps.lm_loss_fn(lcfg)
        _, g_plain = train_steps.value_and_grad(loss_fn, lp, tok, lab)
        _, g_sh = train_steps.value_and_grad(loss_fn, dp, dtok, dlab)
        g_sh = spmd.full_tree(g_sh)
        loss_sh = float(spmd.full(m_sh["loss"]))
        gn_sh = float(spmd.full(m_sh["grad_norm"]))
        err = {"loss": abs(loss_sh / float(m_plain["loss"]) - 1),
               "grad_norm": abs(gn_sh / float(m_plain["grad_norm"]) - 1),
               "grads": max(rel(g_sh[k], g_plain[k]) for k in lp),
               "m": max(rel(st_sh.m[k], st_plain.m[k]) for k in lp),
               "params": share_off(p_sh, p_plain, float(opt.lr_at(ocfg, 1))),
               # a wrong gradient (other labels) must fail the share bound
               "control": share_off(step(lp, opt.init(ocfg, lp), tok,
                                         lab.roll(1, 1))[0], p_plain,
                                    float(opt.lr_at(ocfg, 1)))}
        mark("LM_STEP", err["loss"] <= 1e-5 and err["grad_norm"] <= 1e-5
             and err["grads"] <= 1e-4 and err["m"] <= 1e-4
             and err["params"] <= 1e-2 < err["control"], err)
        # on a one-rank (1, 1) mesh the sharded step takes the plain one's
        # arithmetic: its gradients equal bit for bit, also past the
        # chunked-attention threshold, whose bfloat16 probabilities would
        # raise any rounding apart to ~1e-4 of a gradient's max
        mesh1 = DeviceMesh("cpu", [[0]], mesh_dim_names=("data", "model"))
        if rank == 0:
            g1 = torch.Generator().manual_seed(5)
            tok1 = torch.randint(0, lcfg.vocab_size, (1, 3072), generator=g1,
                                 dtype=torch.int32)
            lab1 = torch.roll(tok1, -1, 1)
            (l1, _), g_1 = train_steps.value_and_grad(loss_fn, lp, tok1, lab1)
            (l1s, _), g_1s = train_steps.value_and_grad(
                loss_fn, spmd.place_tree(lp, mesh1, rules.lm_param_specs(
                    lcfg, lp)),
                spmd.place(tok1, mesh1, bt), spmd.place(lab1, mesh1, bt))
            g_1s = spmd.full_tree(g_1s)
            same = [k for k in lp if torch.equal(g_1s[k], g_1[k])]

            # the witness: the equivalent backward exp(x - m) / z rounds
            # apart, and the bfloat16 probabilities raise it
            def other_form(ctx, g):
                logits, _ = ctx.saved_tensors
                e = torch.exp(logits - spmd.reduce_partial(
                    logits.amax(-1, keepdim=True)))
                return g[..., None] * e / spmd.reduce_partial(
                    e.sum(-1, keepdim=True))

            own = shard_lm._VocabLogZ.backward
            shard_lm._VocabLogZ.backward = staticmethod(other_form)
            try:
                _, g_o = train_steps.value_and_grad(
                    loss_fn, spmd.place_tree(lp, mesh1, rules.lm_param_specs(
                        lcfg, lp)),
                    spmd.place(tok1, mesh1, bt), spmd.place(lab1, mesh1, bt))
            finally:
                shard_lm._VocabLogZ.backward = own
            other = max(rel(spmd.full(g_o[k]), g_1[k]) for k in lp)
            mark("LM_ONE_RANK", lcfg.attn_probs_bf16
                 and torch.equal(spmd.full(l1s), l1) and len(same) == len(lp)
                 and other > 0, {"apart": max(rel(g_1s[k], g_1[k])
                                              for k in lp),
                                 "exp_m_over_z_apart": other})
        out["lm_loss"] = np.float32(loss_sh)
        out["lm_grad_norm"] = np.float32(gn_sh)
        for k in lp:
            out["lm_new." + k] = p_sh[k].numpy()

        # the sequence-sharded chunked attention (heads "model" cannot split)
        acfg = dataclasses.replace(lcfg, n_heads=6, n_kv_heads=3,
                                   attn_probs_bf16=False)
        g = torch.Generator().manual_seed(3)
        q = torch.randn(4, 3072, 6, 8, generator=g)
        k = torch.randn(4, 3072, 3, 8, generator=g)
        v = torch.randn(4, 3072, 3, 8, generator=g)
        want = T.chunked_causal_attention(q, k, v, acfg)
        place4 = lambda t: spmd.place(t, mesh, (("data",), None, None, None))
        with spmd.replicate_plain(place4(q)):
            got = shard_lm.sharded_attention(place4(q), place4(k), place4(v),
                                             None, acfg).full_tensor()
        mark("ATTN_SEQ", rel(got, want) <= 1e-5, rel(got, want))

        # decode over a cache sharded over its sequence (split-KV)
        model = T.Transformer(lcfg)
        model.load_state_dict(lp)
        ck, cv = T.init_cache(lcfg, 8, 32, device="cpu")
        gen = torch.Generator().manual_seed(4)
        ck.copy_(torch.randn(ck.shape, generator=gen))
        cv.copy_(torch.randn(cv.shape, generator=gen))
        spec = rules.lm_cache_specs(mesh, lcfg)
        dk, dv = spmd.place(ck, mesh, spec), spmd.place(cv, mesh, spec)
        decode = train_steps.lm_decode_step(lcfg)
        tok1 = tok[:, :1]
        want_l, want_k, want_v = decode(lp, tok1, ck.clone(), cv.clone(), 20)
        got_l, got_k, got_v = decode(dp, spmd.place(tok1, mesh, bt), dk, dv,
                                     20)
        got_l = got_l.full_tensor()
        ok = (rel(got_l, want_l) <= 1e-5
              and rel(got_k.full_tensor(), want_k) <= 1e-5
              and rel(got_v.full_tensor(), want_v) <= 1e-5)
        mark("DECODE", ok, rel(got_l, want_l))

        if rank == 0:
            np.savez(sys.argv[2], **out)
''')

MARKERS = ("PLACEMENT", "EP_MOE", "EP_AUX", "EP_GRAD", "EP_FALLBACK",
           "ELASTIC_4",
           "ELASTIC_2x2", "LM_STEP", "LM_ONE_RANK", "ATTN_SEQ", "DECODE")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    """Run the worker on 8 gloo ranks; ``(stdout of rank 0, inputs,
    rank 0's results)``."""
    d = tmp_path_factory.mktemp("spmd")
    rng = np.random.default_rng(0)
    inputs = {}
    # the MoE of tests/test_moe_shardmap.py, drawn by the reference
    mcfg = dataclasses.replace(
        rconfigs.get_reduced_config("qwen3-moe-30b-a3b"), d_model=32,
        moe=dataclasses.replace(rconfigs.get_reduced_config(
            "qwen3-moe-30b-a3b").moe, n_experts=8, top_k=2, d_ff_expert=16,
            capacity_factor=8.0), dtype="float32")
    rp = jax.tree_util.tree_map(np.asarray, rmoe.init_moe_params(
        mcfg, jax.random.PRNGKey(0)))
    inputs.update({"moe.router.weight": rp["router"].T.copy(),
                   "moe.w_gate": rp["w_gate"], "moe.w_up": rp["w_up"],
                   "moe.w_down": rp["w_down"]})
    inputs["moe_x"] = rng.standard_normal((8, 16, 32)).astype(np.float32)
    rcfg = rconfigs.get_reduced_config("phi4-mini-3.8b")
    rparams = RT.init_params(rcfg, jax.random.PRNGKey(0))
    state = convert.lm_state_from_reference(
        configs.get_reduced_config("phi4-mini-3.8b"),
        jax.tree_util.tree_map(np.asarray, rparams), device="cpu")
    inputs.update({"lm." + k: v.numpy() for k, v in state.items()})
    inputs["tokens"] = rng.integers(0, rcfg.vocab_size, (8, 16)).astype(
        np.int32)
    inputs["labels"] = rng.integers(0, rcfg.vocab_size, (8, 16)).astype(
        np.int32)
    np.savez(d / "in.npz", **inputs)
    (d / "worker.py").write_text(_WORKER)
    (d / "ckpt").mkdir()
    port = _free_port()
    env = {**os.environ, "PYTHONPATH": "src", "MASTER_ADDR": "localhost",
           "MASTER_PORT": str(port), "WORLD_SIZE": str(N_RANKS),
           "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen(
        [sys.executable, str(d / "worker.py"), str(d / "in.npz"),
         str(d / "out.npz"), str(d / "ckpt")],
        env={**env, "RANK": str(r), "LOCAL_RANK": str(r)},
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(N_RANKS)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=240))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    codes = [p.returncode for p in procs]
    results = (dict(np.load(d / "out.npz")) if (d / "out.npz").exists()
               else {})
    return outs[0][0], "\n".join(o[1][-1500:] for o in outs), codes, \
        inputs, results, (rparams, rcfg)


@pytest.mark.parametrize("marker", MARKERS)
def test_spawned_rank_checks(spawned, marker):
    stdout, stderr, codes, *_ = spawned
    assert codes == [0] * N_RANKS, stderr[-3000:]
    lines = {ln.split()[0]: ln for ln in stdout.splitlines() if ln.strip()}
    assert marker in lines, (stdout, stderr[-2000:])


def test_ep_moe_matches_reference(spawned):
    *_, inputs, results, _ = spawned
    assert "moe_y_ep" in results
    mcfg = dataclasses.replace(
        rconfigs.get_reduced_config("qwen3-moe-30b-a3b"), d_model=32,
        moe=dataclasses.replace(rconfigs.get_reduced_config(
            "qwen3-moe-30b-a3b").moe, n_experts=8, top_k=2, d_ff_expert=16,
            capacity_factor=8.0), dtype="float32")
    rp = {"router": inputs["moe.router.weight"].T,
          "w_gate": inputs["moe.w_gate"], "w_up": inputs["moe.w_up"],
          "w_down": inputs["moe.w_down"]}
    y, aux = rmoe._moe_ffn_dense(jax.tree_util.tree_map(jnp.asarray, rp),
                                 jnp.asarray(inputs["moe_x"]), mcfg)
    np.testing.assert_allclose(results["moe_y_ep"], np.asarray(y),
                               rtol=0, atol=2e-5)
    np.testing.assert_allclose(float(results["moe_aux_ep"]), float(aux),
                               rtol=2e-2)


def test_sharded_lm_step_matches_reference(spawned):
    *_, inputs, results, (rparams, rcfg) = spawned
    assert "lm_loss" in results
    ocfg = ropt.OptimizerConfig(name="adamw")
    step = rsteps.lm_train_step(rcfg, ocfg)
    new_p, _, metrics = step(rparams, ropt.init(ocfg, rparams),
                             jnp.asarray(inputs["tokens"]),
                             jnp.asarray(inputs["labels"]))
    np.testing.assert_allclose(float(results["lm_loss"]),
                               float(metrics["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(results["lm_grad_norm"]),
                               float(metrics["grad_norm"]), rtol=1e-5)
    want = convert.lm_state_from_reference(
        configs.get_reduced_config("phi4-mini-3.8b"),
        jax.tree_util.tree_map(np.asarray, new_p), device="cpu")
    lr = float(ropt.lr_at(ocfg, 1))
    for k, w in want.items():
        w = w.numpy()
        d = np.abs(results["lm_new." + k] - w)
        assert (d > 1e-2 * lr).mean() <= 1e-2, k
