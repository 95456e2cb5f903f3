"""Per-(arch × shape) dry-run cells, the port of ``repro.launch.specs``:
the step, its arguments as meta tensors (``device="meta"``: shapes and
dtypes, nothing allocated; the counterpart of ``ShapeDtypeStruct``) and
their spec trees (``sharding.rules``).

Parameters come from the port's own modules built on ``meta``, as named
tensors; the optimizer state from ``optimizer.init`` over them. The
tables, the optimizer choice, the parameter dtypes, the ``grad_accum``
defaults, ``donate`` and the ``meta`` formulas are the reference's.

An LM cell's step is the port's (``train_steps.lm_*_step``); its decode
arguments end with the cache length as a 0-dim int32 tensor, which
``dryrun.py`` passes to the step as an int. The GNN and DIN cells carry
the reference's arguments and specs (a GNN batch as a dict of the
reference's ``GraphBatch`` fields, its ELL view a ``core.b2sr.B2SREll``
of int32 words); ``dryrun.py`` does not run them yet.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.configs import DINConfig, GNNConfig, TransformerConfig
from repro_torch.configs import get_config
from repro_torch.core.b2sr import B2SREll, ceil_div
from repro_torch.models.gnn import graphcast as graphcast_mod
from repro_torch.models.recsys.din import DIN, DINBatch
from repro_torch.models.transformer import Transformer
from repro_torch.sharding import rules
from repro_torch.training import optimizer as opt_mod
from repro_torch.training import train_steps

META = torch.device("meta")


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def _pad512(n: int) -> int:
    """Pad counts to a 512 multiple so inputs shard evenly on every mesh
    (the data loader pads with masked entries in the real pipeline)."""
    return -(-n // 512) * 512


@dataclasses.dataclass
class Cell:
    arch: str
    shape_id: str
    kind: str                       # train | prefill | decode | serve | retrieval
    step: Callable
    args: Tuple[Any, ...]           # trees of meta tensors
    in_specs: Tuple[Any, ...]       # spec trees (same structure)
    out_specs: Any                  # spec trees or None (as the step leaves it)
    donate: Tuple[int, ...]
    meta: Dict[str, Any]


def _params(module_cls, cfg, dtype=None) -> Dict[str, torch.Tensor]:
    with META:
        model = module_cls(cfg)
    return {k: v.detach() if dtype is None or not v.is_floating_point()
            else v.detach().to(dtype) for k, v in model.named_parameters()}


def _n_params(params: Dict[str, torch.Tensor]) -> int:
    return sum(v.numel() for v in params.values())


def _replicated_like(tree) -> Any:
    """``()`` (replicated) for every tensor of a dict or named tuple."""
    if isinstance(tree, dict):
        return {k: () for k in tree}
    return type(tree)(*(() for _ in tree))


# ---------------------------------------------------------------------------
# LM cells
# ---------------------------------------------------------------------------

LM_SHAPE_TABLE = {
    "train_4k": dict(seq=4096, batch=256, kind="train"),
    "prefill_32k": dict(seq=32768, batch=32, kind="prefill"),
    "decode_32k": dict(seq=32768, batch=128, kind="decode"),
    "long_500k": dict(seq=524288, batch=1, kind="decode"),
}


def _lm_opt_cfg(cfg: TransformerConfig) -> opt_mod.OptimizerConfig:
    # arctic-480b: bfloat16 parameters and SGD-momentum, the only state
    # budget that fits 480B on 256 ranks; the others AdamW in float32
    if cfg.name.startswith("arctic"):
        return opt_mod.OptimizerConfig(name="sgd", moment_dtype="bfloat16")
    return opt_mod.OptimizerConfig(name="adamw")


def _lm_param_dtype(cfg: TransformerConfig, kind: str) -> torch.dtype:
    if kind != "train":
        return torch.bfloat16
    return torch.bfloat16 if cfg.name.startswith("arctic") else torch.float32


def build_lm_cell(arch: str, shape_id: str, mesh,
                  cfg: Optional[TransformerConfig] = None,
                  overrides: Optional[Dict[str, Any]] = None) -> Cell:
    cfg = cfg if cfg is not None else get_config(arch)
    overrides = overrides or {}
    info = LM_SHAPE_TABLE[shape_id]
    B, S = info["batch"], info["seq"]
    kind = info["kind"]
    ba = rules.batch_axes(mesh)
    tp = rules.axis_sizes(mesh).get("model", 0)
    cfg = dataclasses.replace(cfg, batch_axes=tuple(ba), tp_width=tp)

    params = _params(Transformer, cfg, _lm_param_dtype(cfg, kind))
    p_specs = rules.lm_param_specs(cfg, params)

    tokens_per_step = B * S
    meta = dict(n_params=cfg.n_params(), n_active=cfg.n_active_params(),
                tokens=tokens_per_step)
    attn = cfg.n_layers * cfg.n_heads * cfg.head_dim

    if kind == "train":
        opt_cfg = _lm_opt_cfg(cfg)
        opt_state = opt_mod.init(opt_cfg, params)
        o_specs = rules.opt_state_specs(p_specs, opt_state)
        # gradient accumulation where the activations overflow a chip at
        # global batch 256 (the reference's defaults)
        default_accum = {"gemma-7b": 4, "minitron-4b": 2}.get(arch, 1)
        grad_accum = int(overrides.get("grad_accum", default_accum))
        step = train_steps.lm_train_step(cfg, opt_cfg, grad_accum=grad_accum)
        tok = _meta((B, S), torch.int32)
        args = (params, opt_state, tok, tok)
        in_specs = (p_specs, o_specs, (ba, None), (ba, None))
        out_specs = (p_specs, o_specs, None)
        meta["model_flops"] = 6 * meta["n_active"] * tokens_per_step \
            + 12 * attn * B * S * S // 2
        return Cell(arch, shape_id, kind, step, args, in_specs, out_specs,
                    donate=(0, 1), meta=meta)

    if kind == "prefill":
        step = train_steps.lm_prefill_step(cfg)
        args = (params, _meta((B, S), torch.int32))
        in_specs = (p_specs, (ba, None))
        cache_spec = rules.lm_cache_specs(mesh, cfg)
        out_specs = (None, (cache_spec, cache_spec))
        meta["model_flops"] = 2 * meta["n_active"] * tokens_per_step \
            + 4 * attn * B * S * S // 2
        return Cell(arch, shape_id, kind, step, args, in_specs, out_specs,
                    donate=(), meta=meta)

    # decode: one token against a full cache of length S
    step = train_steps.lm_decode_step(cfg)
    cache = _meta((cfg.n_layers, B, S, cfg.n_kv_heads, cfg.head_dim),
                  torch.bfloat16)
    cache_spec = rules.lm_cache_specs(mesh, cfg)
    args = (params, _meta((B, 1), torch.int32), cache, cache,
            _meta((), torch.int32))
    in_specs = (p_specs, (ba, None), cache_spec, cache_spec, ())
    out_specs = (None, cache_spec, cache_spec)
    meta["tokens"] = B
    meta["model_flops"] = 2 * meta["n_active"] * B \
        + 4 * cfg.n_layers * cfg.n_kv_heads * cfg.head_dim * B * S
    return Cell(arch, shape_id, kind, step, args, in_specs, out_specs,
                donate=(2, 3), meta=meta)


# ---------------------------------------------------------------------------
# GNN cells
# ---------------------------------------------------------------------------

GNN_SHAPE_TABLE = {
    "full_graph_sm": dict(n_nodes=2708, n_edges=10556, d_feat=1433,
                          kind="train", b2sr_k=16),
    "minibatch_lg": dict(n_nodes=232965, n_edges=114615892, batch_nodes=1024,
                         fanout=(15, 10), d_feat=None, kind="train"),
    "ogb_products": dict(n_nodes=2449029, n_edges=61859140, d_feat=100,
                         kind="train", b2sr_k=64),
    "molecule": dict(n_nodes=30, n_edges=64, batch=128, d_feat=None,
                     kind="train"),
}


def _gnn_batch_shapes(cfg: GNNConfig, shape_id: str,
                      b2sr_k: Optional[int] = None) -> Dict[str, Any]:
    """The reference's ``GraphBatch`` fields as meta tensors."""
    info = dict(GNN_SHAPE_TABLE[shape_id])
    if b2sr_k is not None and "b2sr_k" in info:
        info["b2sr_k"] = b2sr_k
    d_in = info["d_feat"] or cfg.d_in
    if cfg.family == "graphcast":
        d_in = cfg.d_in                       # arch-pinned (n_vars)
    if shape_id == "minibatch_lg":
        from repro_torch.data.neighbor_sampler import sampled_sizes
        N, E = sampled_sizes(info["batch_nodes"], info["fanout"])
        n_graphs = 1
    elif shape_id == "molecule":
        N = info["batch"] * info["n_nodes"]
        E = info["batch"] * info["n_edges"]
        n_graphs = info["batch"]
    else:
        N, E = info["n_nodes"], info["n_edges"]
        n_graphs = 1
    N, E = _pad512(N), _pad512(E)
    ell = None
    if cfg.family == "gcn" and cfg.use_b2sr and "b2sr_k" in info:
        t, K = cfg.tile_dim, info["b2sr_k"]
        R = ceil_div(N, t)
        ell = B2SREll(tile_col_idx=_meta((R, K), torch.int32),
                      bit_tiles=_meta((R, K, t), torch.int32),
                      row_n_tiles=_meta((R,), torch.int32),
                      tile_dim=t, n_rows=N, n_cols=N)
    i32, b8, f32 = torch.int32, torch.bool, torch.float32
    return dict(
        node_feat=_meta((N, d_in), f32),
        senders=_meta((E,), i32), receivers=_meta((E,), i32),
        node_mask=_meta((N,), b8), edge_mask=_meta((E,), b8),
        labels=_meta((n_graphs,) if n_graphs > 1 else (N,), i32),
        train_mask=_meta((N,), b8), graph_ids=_meta((N,), i32),
        coords=_meta((N, 3), f32) if cfg.family == "egnn" else None,
        edge_feat=None, ell=ell,
        degrees=_meta((N,), f32) if cfg.family == "gcn" else None,
        n_graphs=n_graphs)


def _gnn_module(cfg: GNNConfig):
    from repro_torch.models.gnn import egnn, gatedgcn, gcn
    return {"gcn": gcn.GCN, "gatedgcn": gatedgcn.GatedGCN,
            "egnn": egnn.EGNN, "graphcast": graphcast_mod.GraphCast}[
        cfg.family]


def build_gnn_cell(arch: str, shape_id: str, mesh,
                   cfg: Optional[GNNConfig] = None,
                   overrides: Optional[Dict[str, Any]] = None) -> Cell:
    cfg = cfg if cfg is not None else get_config(arch)
    overrides = overrides or {}
    info = GNN_SHAPE_TABLE[shape_id]
    opt_cfg = opt_mod.OptimizerConfig(name="adamw")

    if cfg.family == "graphcast":
        N = (info["batch"] * info["n_nodes"] if shape_id == "molecule"
             else (info["n_nodes"] if shape_id != "minibatch_lg" else 232965))
        N = _pad512(N)
        n_mesh, n_medges = graphcast_mod.mesh_sizes(cfg.mesh_refinement)
        n_medges = _pad512(n_medges)
        i32 = torch.int32
        mesh_arrays = graphcast_mod.MeshSpec(
            g2m_senders=_meta((N,), i32), g2m_receivers=_meta((N,), i32),
            mesh_senders=_meta((n_medges,), i32),
            mesh_receivers=_meta((n_medges,), i32),
            m2g_senders=_meta((3 * N,), i32),
            m2g_receivers=_meta((3 * N,), i32), n_mesh=n_mesh)
        params = _params(graphcast_mod.GraphCast, cfg)
        opt_state = opt_mod.init(opt_cfg, params)
        feat = _meta((N, cfg.d_in), torch.float32)
        target = _meta((N, cfg.n_classes), torch.float32)

        def step(params, opt_state, feat, target, mesh_arrays):
            s = train_steps.graphcast_train_step(cfg, opt_cfg, mesh_arrays)
            return s(params, opt_state, feat, target)

        node_axes = rules.best_dim0_axes(mesh, N) or ()
        medge_axes = rules.best_dim0_axes(mesh, n_medges) or ()
        m2g_axes = rules.best_dim0_axes(mesh, 3 * N) or ()
        mesh_specs = graphcast_mod.MeshSpec(
            g2m_senders=(node_axes,), g2m_receivers=(node_axes,),
            mesh_senders=(medge_axes,), mesh_receivers=(medge_axes,),
            m2g_senders=(m2g_axes,), m2g_receivers=(m2g_axes,),
            n_mesh=n_mesh)
        p_specs = _replicated_like(params)
        o_specs = rules.opt_state_specs(p_specs, opt_state)
        d = cfg.d_hidden
        meta = dict(n_params=_n_params(params), tokens=N,
                    model_flops=6 * (2 * N * cfg.d_in * d
                                     + cfg.n_layers * n_medges * 3 * d ** 2
                                     + cfg.n_layers * n_mesh * 2 * d ** 2
                                     + 3 * N * 2 * d ** 2))
        return Cell(arch, shape_id, "train", step,
                    (params, opt_state, feat, target, mesh_arrays),
                    (p_specs, o_specs, (node_axes, None), (node_axes, None),
                     mesh_specs),
                    (p_specs, o_specs, None), donate=(0, 1), meta=meta)

    if (cfg.family == "gcn" and cfg.use_b2sr and shape_id == "ogb_products"
            and "tile_dim" not in overrides):
        # B2SR-8, Algorithm 1's choice for the ogb-scale community graph
        cfg = dataclasses.replace(cfg, tile_dim=8)
    batch = _gnn_batch_shapes(cfg, shape_id, b2sr_k=overrides.get("b2sr_k"))
    cfg_cell = dataclasses.replace(cfg,
                                   d_in=int(batch["node_feat"].shape[1]))
    if (cfg.family in ("gcn", "gatedgcn")
            and overrides.get("shardmap_agg", True)):
        # receiver-partitioned aggregation: node and edge arrays shard
        # over the same axes
        ax = rules.best_dim0_axes(mesh, int(batch["node_feat"].shape[0]))
        cfg_cell = dataclasses.replace(cfg_cell,
                                       shardmap_agg_axes=tuple(ax or ()))
    params = _params(_gnn_module(cfg_cell), cfg_cell)
    opt_state = opt_mod.init(opt_cfg, params)
    step = train_steps.gnn_train_step(cfg_cell, opt_cfg)
    b_specs = rules.gnn_batch_specs(mesh, batch)
    p_specs = _replicated_like(params)
    o_specs = rules.opt_state_specs(p_specs, opt_state)
    N = batch["node_feat"].shape[0]
    E = batch["senders"].shape[0]
    d = cfg_cell.d_hidden
    flops_per_layer = 2 * E * d + 2 * N * d * d
    if cfg.family == "gatedgcn":
        flops_per_layer = 2 * E * 3 * d * d + 2 * N * 2 * d * d
    if cfg.family == "egnn":
        flops_per_layer = 2 * E * (2 * d + 1) * d * 4
    meta = dict(n_params=_n_params(params), tokens=N,
                model_flops=3 * cfg.n_layers * flops_per_layer)
    return Cell(arch, shape_id, "train", step, (params, opt_state, batch),
                (p_specs, o_specs, b_specs), (p_specs, o_specs, None),
                donate=(0, 1), meta=meta)


# ---------------------------------------------------------------------------
# DIN cells
# ---------------------------------------------------------------------------

DIN_SHAPE_TABLE = {
    "train_batch": dict(batch=65536, kind="train"),
    "serve_p99": dict(batch=512, kind="serve"),
    "serve_bulk": dict(batch=262144, kind="serve"),
    "retrieval_cand": dict(batch=1, n_candidates=1_000_000, kind="retrieval"),
}


def _din_batch_shapes(cfg: DINConfig, batch: int) -> DINBatch:
    L, i32 = cfg.seq_len, torch.int32
    return DINBatch(
        hist_items=_meta((batch, L), i32), hist_cates=_meta((batch, L), i32),
        hist_mask=_meta((batch, L), torch.bool),
        target_item=_meta((batch,), i32), target_cate=_meta((batch,), i32),
        user_feats=_meta((batch, cfg.n_user_feats), i32),
        labels=_meta((batch,), torch.float32))


def build_din_cell(arch: str, shape_id: str, mesh,
                   cfg: Optional[DINConfig] = None,
                   overrides: Optional[Dict[str, Any]] = None) -> Cell:
    cfg = cfg if cfg is not None else get_config(arch)
    info = DIN_SHAPE_TABLE[shape_id]
    B, kind = info["batch"], info["kind"]
    params = _params(DIN, cfg)
    p_specs = rules.din_param_specs(cfg, params)
    batch = _din_batch_shapes(cfg, B)
    b_specs = (rules.din_batch_specs(mesh, batch) if B > 1
               else _replicated_like(batch))
    n_params = _n_params(params)
    d = cfg.embed_dim
    attn_flops_per = 2 * cfg.seq_len * (8 * d * cfg.attn_mlp[0]
                                        + cfg.attn_mlp[0] * cfg.attn_mlp[1])
    mlp_in = cfg.n_user_feats * d + 4 * d
    mlp_flops_per = 2 * (mlp_in * cfg.mlp[0] + cfg.mlp[0] * cfg.mlp[1])
    fwd = attn_flops_per + mlp_flops_per

    if kind == "train":
        opt_cfg = opt_mod.OptimizerConfig(name="adamw")
        opt_state = opt_mod.init(opt_cfg, params)
        o_specs = rules.opt_state_specs(p_specs, opt_state)
        step = train_steps.din_train_step(cfg, opt_cfg)
        meta = dict(n_params=n_params, tokens=B, model_flops=3 * B * fwd)
        return Cell(arch, shape_id, kind, step, (params, opt_state, batch),
                    (p_specs, o_specs, b_specs), (p_specs, o_specs, None),
                    donate=(0, 1), meta=meta)

    if kind == "serve":
        step = train_steps.din_serve_step(cfg)
        meta = dict(n_params=n_params, tokens=B, model_flops=B * fwd)
        return Cell(arch, shape_id, kind, step, (params, batch),
                    (p_specs, b_specs), None, donate=(), meta=meta)

    # retrieval: 1 user × 1M candidates; candidates shard over all axes
    N = _pad512(info["n_candidates"])
    step = train_steps.din_retrieval_step(cfg)
    cands = _meta((N,), torch.int32)
    cand_spec = (rules.best_dim0_axes(mesh, N) or ("model",),)
    meta = dict(n_params=n_params, tokens=N, model_flops=N * fwd)
    return Cell(arch, shape_id, kind, step, (params, batch, cands, cands),
                (p_specs, _replicated_like(batch), cand_spec, cand_spec),
                None, donate=(), meta=meta)


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------

def build_cell(arch: str, shape_id: str, mesh,
               overrides: Optional[Dict[str, Any]] = None) -> Cell:
    cfg = get_config(arch)
    if overrides:
        cfg_over = {k: v for k, v in overrides.items()
                    if k in {f.name for f in dataclasses.fields(cfg)}}
        if cfg_over:
            cfg = dataclasses.replace(cfg, **cfg_over)
    if isinstance(cfg, TransformerConfig):
        return build_lm_cell(arch, shape_id, mesh, cfg, overrides or {})
    if isinstance(cfg, GNNConfig):
        return build_gnn_cell(arch, shape_id, mesh, cfg, overrides or {})
    return build_din_cell(arch, shape_id, mesh, cfg, overrides or {})


def input_specs(arch: str, shape_id: str, mesh):
    """Meta-tensor stand-ins for every input of the cell's step."""
    return build_cell(arch, shape_id, mesh).args
