"""Train and inference steps for the LM, GNN and recsys families, the
port of ``repro.training.train_steps``: ``lm_train_step``,
``lm_prefill_step``, ``lm_decode_step``, ``gnn_train_step``,
``gnn_infer_step``, ``graphcast_train_step``, ``graphcast_infer_step``,
``din_train_step``, ``din_serve_step`` and ``din_retrieval_step``.

A step is a function of the parameters (a dict ``name -> tensor``, the
model's ``named_parameters``), the optimizer state and a batch. The model
is built once on the ``meta`` device and run over the given tensors with
``torch.func.functional_call``, so the step holds no weights of its own.
One train step runs the forward, ``autograd.grad`` (on ``b2sr_cuda`` the
GCN aggregation's gradient is ``spmm_dense`` over Aᵀ) and
``optimizer.update``, and returns ``(params, opt_state, metrics)`` with
``loss``, ``lr`` and ``grad_norm`` among the metrics. Families: the
transformers through ``lm_*`` (``grad_accum`` microbatches: the mean of
their gradients), gcn, gatedgcn and egnn through ``gnn_*``, graphcast
through ``graphcast_*``, DIN through ``din_*``.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch
from torch import nn
from torch.func import functional_call

from repro_torch.configs.gnn import GNNConfig
from repro_torch.configs.lm import TransformerConfig
from repro_torch.configs.recsys import DINConfig
from repro_torch.models import transformer as T
from repro_torch.models.gnn import egnn, gatedgcn, gcn, graphcast
from repro_torch.models.recsys.din import DIN
from repro_torch.sharding import spmd
from repro_torch.training import optimizer as opt_mod
from repro_torch.training.optimizer import Tensors

_GNN_MODULES = {"gcn": (gcn.GCN, gcn.loss_fn),
                "gatedgcn": (gatedgcn.GatedGCN, gatedgcn.loss_fn),
                "egnn": (egnn.EGNN, egnn.loss_fn)}


class _Loss(nn.Module):
    """``loss(model, *batch)`` as a module over ``model``'s parameters
    (prefixed ``model.``), so ``functional_call`` binds every parameter a
    loss reads, the heads applied outside ``forward`` included (and any
    other function of the model: the LM's prefill and decode)."""

    def __init__(self, model: nn.Module, loss: Callable):
        super().__init__()
        self.model, self.loss = model, loss

    def forward(self, *batch):
        return self.loss(self.model, *batch)


def _family(cfg: GNNConfig, mesh=None):
    """The family's model on the ``meta`` device and its loss. ``mesh``
    reaches GatedGCN's sharded aggregation (the GCN finds its sharded
    graph through ``gnn_bit.layers.prepare_sharded``)."""
    if cfg.family not in _GNN_MODULES:
        raise NotImplementedError(
            f"GNN family {cfg.family!r} has no gnn step (graphcast: "
            f"graphcast_train_step; ported: {sorted(_GNN_MODULES)})")
    model_cls, loss = _GNN_MODULES[cfg.family]
    kw = {"mesh": mesh} if cfg.family == "gatedgcn" else {}
    with torch.device("meta"):
        return model_cls(cfg, **kw), loss


def _bound_loss(model: nn.Module, loss: Callable) -> Callable:
    """``loss_fn(params, *batch)`` over the parameter dict (``loss`` may
    be any function of the model and the batch)."""
    wrapper = _Loss(model, loss)

    def loss_fn(params: Tensors, *batch):
        return functional_call(
            wrapper, {f"model.{k}": v for k, v in params.items()}, batch,
            strict=True)

    return loss_fn


def value_and_grad(loss_fn: Callable, params: Tensors, *batch
                   ) -> Tuple[Tuple[torch.Tensor, Dict], Tensors]:
    """``((loss, metrics), grads)`` of ``loss_fn(params, *batch)`` in every
    parameter (``jax.value_and_grad(…, has_aux=True)``'s contract)."""
    leaves = {k: p.detach().requires_grad_(True) for k, p in params.items()}
    # DTensor parameters: the model's plain constants act as replicated,
    # in the backward's recomputation too
    with spmd.replicate_plain(leaves):
        loss, metrics = loss_fn(leaves, *batch)
        grads = torch.autograd.grad(loss, list(leaves.values()),
                                    allow_unused=True)
    # a parameter the loss does not reach (GatedGCN's edge embedding on a
    # batch without edge features, EGNN's last coordinate update) gets a
    # zero gradient, as under JAX
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves.values(), grads)]
    metrics = {k: v.detach() for k, v in metrics.items()}
    return (loss.detach(), metrics), dict(zip(leaves, grads))


def _apply(opt_cfg: opt_mod.OptimizerConfig, loss_fn: Callable,
           params: Tensors, opt_state: opt_mod.OptState, *batch):
    (loss, metrics), grads = value_and_grad(loss_fn, params, *batch)
    new_params, new_state, opt_metrics = opt_mod.update(
        opt_cfg, grads, opt_state, params)
    return new_params, new_state, dict(metrics, loss=loss, **opt_metrics)


# ---------------------------------------------------------------------------
# LM transformers
# ---------------------------------------------------------------------------

def _lm_model(cfg: TransformerConfig) -> T.Transformer:
    with torch.device("meta"):
        return T.Transformer(cfg)


def lm_loss_fn(cfg: TransformerConfig) -> Callable:
    """``loss_fn(params, tokens, labels) -> (loss, {"ce", "aux"})``."""
    return _bound_loss(_lm_model(cfg), T.loss_fn)


def lm_train_step(cfg: TransformerConfig, opt_cfg: opt_mod.OptimizerConfig,
                  grad_accum: int = 1) -> Callable:
    """``step(params, opt_state, tokens, labels) -> (params, opt_state,
    metrics)``; with ``grad_accum > 1`` the batch is cut into that many
    microbatches of consecutive rows, the update takes the mean of their
    gradients and ``loss`` is the mean of their losses."""
    loss_fn = lm_loss_fn(cfg)

    def step(params: Tensors, opt_state: opt_mod.OptState, tokens, labels):
        if grad_accum == 1:
            return _apply(opt_cfg, loss_fn, params, opt_state, tokens,
                          labels)
        B = tokens.shape[0]
        if B % grad_accum:
            raise ValueError(f"batch {B} is not a multiple of grad_accum "
                             f"{grad_accum}")
        mb = B // grad_accum
        grads = {k: torch.zeros_like(p, dtype=torch.float32)
                 for k, p in params.items()}
        loss_sum = 0.0
        for i in range(grad_accum):
            rows = slice(i * mb, (i + 1) * mb)
            (loss, _), g = value_and_grad(loss_fn, params, tokens[rows],
                                          labels[rows])
            for k in grads:
                grads[k] += g[k]
            loss_sum = loss_sum + loss
            del g
        grads = {k: g / grad_accum for k, g in grads.items()}
        new_params, new_state, opt_metrics = opt_mod.update(
            opt_cfg, grads, opt_state, params)
        return new_params, new_state, dict(loss=loss_sum / grad_accum,
                                           **opt_metrics)

    return step


def lm_prefill_step(cfg: TransformerConfig) -> Callable:
    """``step(params, tokens) -> (logits [B, 1, V], (cache_k, cache_v))``:
    the prompt's keys and values and the last position's logits."""
    run = _bound_loss(_lm_model(cfg),
                      lambda m, tokens: T.prefill(m, tokens, last_only=True))

    @torch.no_grad()
    def step(params: Tensors, tokens):
        return run(params, tokens)

    return step


def lm_decode_step(cfg: TransformerConfig) -> Callable:
    """``step(params, token, cache_k, cache_v, cache_len) -> (logits,
    cache_k, cache_v)`` (the caches written in place and returned)."""
    run = _bound_loss(_lm_model(cfg), T.decode_step)

    @torch.no_grad()
    def step(params: Tensors, token, cache_k, cache_v, cache_len: int):
        return run(params, token, cache_k, cache_v, cache_len)

    return step


# ---------------------------------------------------------------------------
# GNN
# ---------------------------------------------------------------------------

def gnn_loss_fn(cfg: GNNConfig, mesh=None) -> Callable:
    """``loss_fn(params, batch) -> (loss, {"ce": loss})`` of ``cfg``'s
    family over the parameter dict."""
    return _bound_loss(*_family(cfg, mesh))


def gnn_train_step(cfg: GNNConfig, opt_cfg: opt_mod.OptimizerConfig,
                   mesh=None) -> Callable:
    """``step(params, opt_state, batch) -> (params, opt_state, metrics)``."""
    loss_fn = gnn_loss_fn(cfg, mesh)

    def step(params: Tensors, opt_state: opt_mod.OptState, batch):
        return _apply(opt_cfg, loss_fn, params, opt_state, batch)

    return step


def gnn_infer_step(cfg: GNNConfig, mesh=None) -> Callable:
    """``step(params, batch) -> logits`` (no gradients; EGNN's node
    states, the first of its outputs)."""
    model, _ = _family(cfg, mesh)

    @torch.no_grad()
    def step(params: Tensors, batch):
        out = functional_call(model, params, (batch,), strict=True)
        return out[0] if isinstance(out, tuple) else out

    return step


def graphcast_loss_fn(cfg: GNNConfig, mesh_spec: graphcast.MeshSpec
                      ) -> Callable:
    """``loss_fn(params, feat, target) -> (loss, {"mse": loss})``."""
    with torch.device("meta"):
        model = graphcast.GraphCast(cfg)
    bound = _bound_loss(model, graphcast.loss_fn)

    def loss_fn(params: Tensors, feat, target):
        return bound(params, feat, target, mesh_spec)

    return loss_fn


def graphcast_train_step(cfg: GNNConfig, opt_cfg: opt_mod.OptimizerConfig,
                         mesh_spec: graphcast.MeshSpec) -> Callable:
    """``step(params, opt_state, feat, target) -> (params, opt_state,
    metrics)``."""
    loss_fn = graphcast_loss_fn(cfg, mesh_spec)

    def step(params: Tensors, opt_state: opt_mod.OptState, feat, target):
        return _apply(opt_cfg, loss_fn, params, opt_state, feat, target)

    return step


def graphcast_infer_step(cfg: GNNConfig,
                         mesh_spec: graphcast.MeshSpec) -> Callable:
    """``step(params, feat) -> prediction`` (no gradients)."""
    with torch.device("meta"):
        model = graphcast.GraphCast(cfg)

    @torch.no_grad()
    def step(params: Tensors, feat):
        return functional_call(model, params, (feat, mesh_spec), strict=True)

    return step


# ---------------------------------------------------------------------------
# DIN
# ---------------------------------------------------------------------------

def _din_model(cfg: DINConfig) -> DIN:
    with torch.device("meta"):
        return DIN(cfg)


def din_loss_fn(cfg: DINConfig) -> Callable:
    """``loss_fn(params, batch) -> (loss, {"bce": loss})``."""
    return _bound_loss(_din_model(cfg), DIN.loss_fn)


def din_train_step(cfg: DINConfig, opt_cfg: opt_mod.OptimizerConfig
                   ) -> Callable:
    """``step(params, opt_state, batch) -> (params, opt_state, metrics)``
    (the tables' gradients dense, every row updated)."""
    loss_fn = din_loss_fn(cfg)

    def step(params: Tensors, opt_state: opt_mod.OptState, batch):
        return _apply(opt_cfg, loss_fn, params, opt_state, batch)

    return step


def din_serve_step(cfg: DINConfig) -> Callable:
    """``step(params, batch) -> logits [B]`` (no gradients)."""
    run = _bound_loss(_din_model(cfg), DIN.forward)

    @torch.no_grad()
    def step(params: Tensors, batch):
        return run(params, batch)

    return step


def din_retrieval_step(cfg: DINConfig) -> Callable:
    """``step(params, batch, cand_items, cand_cates) -> logits [B, N]``:
    ``DIN.score_candidates`` in its blocks of 4,096 (no gradients)."""
    run = _bound_loss(_din_model(cfg), DIN.score_candidates)

    @torch.no_grad()
    def step(params: Tensors, batch, cand_items, cand_cates):
        return run(params, batch, cand_items, cand_cates)

    return step
