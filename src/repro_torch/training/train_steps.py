"""Train and inference step builders for the GNN family, the port of
``repro.training.train_steps``'s ``gnn_train_step`` and
``gnn_infer_step``.

A step is a function of the parameters (a dict ``name -> tensor``, the
model's ``named_parameters``), the optimizer state and a batch. The model
is built once on the ``meta`` device and run over the given tensors with
``torch.func.functional_call``, so the step holds no weights of its own.
One train step runs the forward, ``autograd.grad`` (on ``b2sr_cuda`` the
aggregation's gradient is ``spmm_dense`` over Aᵀ) and ``optimizer.update``,
and returns ``(params, opt_state, metrics)`` with ``loss``, ``lr`` and
``grad_norm`` among the metrics. The port has the GCN only: the other
families (gatedgcn, egnn, graphcast) and the LM and DIN steps wait for
ROADMAP Queue 1 item 10.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch
from torch.func import functional_call

from repro_torch.configs.gnn import GNNConfig
from repro_torch.models.gnn import gcn
from repro_torch.training import optimizer as opt_mod
from repro_torch.training.optimizer import Tensors

_GNN_MODULES = {"gcn": (gcn.GCN, gcn.loss_fn)}


def _family(cfg: GNNConfig):
    if cfg.family not in _GNN_MODULES:
        raise NotImplementedError(
            f"GNN family {cfg.family!r} is not ported yet (ROADMAP Queue 1 "
            f"item 10); ported: {sorted(_GNN_MODULES)}")
    model_cls, loss = _GNN_MODULES[cfg.family]
    with torch.device("meta"):
        return model_cls(cfg), loss


def value_and_grad(loss_fn: Callable, params: Tensors, *batch
                   ) -> Tuple[Tuple[torch.Tensor, Dict], Tensors]:
    """``((loss, metrics), grads)`` of ``loss_fn(params, *batch)`` in every
    parameter (``jax.value_and_grad(…, has_aux=True)``'s contract)."""
    leaves = {k: p.detach().requires_grad_(True) for k, p in params.items()}
    loss, metrics = loss_fn(leaves, *batch)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    metrics = {k: v.detach() for k, v in metrics.items()}
    return (loss.detach(), metrics), dict(zip(leaves, grads))


def _apply(opt_cfg: opt_mod.OptimizerConfig, loss_fn: Callable,
           params: Tensors, opt_state: opt_mod.OptState, *batch):
    (loss, metrics), grads = value_and_grad(loss_fn, params, *batch)
    new_params, new_state, opt_metrics = opt_mod.update(
        opt_cfg, grads, opt_state, params)
    return new_params, new_state, dict(metrics, loss=loss, **opt_metrics)


def gnn_loss_fn(cfg: GNNConfig) -> Callable:
    """``loss_fn(params, batch) -> (loss, {"ce": loss})`` of ``cfg``'s
    family over the parameter dict."""
    model, loss = _family(cfg)

    def loss_fn(params: Tensors, batch):
        return loss(lambda b: functional_call(model, params, (b,)), batch)

    return loss_fn


def gnn_train_step(cfg: GNNConfig,
                   opt_cfg: opt_mod.OptimizerConfig) -> Callable:
    """``step(params, opt_state, batch) -> (params, opt_state, metrics)``."""
    loss_fn = gnn_loss_fn(cfg)

    def step(params: Tensors, opt_state: opt_mod.OptState, batch):
        return _apply(opt_cfg, loss_fn, params, opt_state, batch)

    return step


def gnn_infer_step(cfg: GNNConfig) -> Callable:
    """``step(params, batch) -> logits`` (no gradients)."""
    model, _ = _family(cfg)

    @torch.no_grad()
    def step(params: Tensors, batch):
        return functional_call(model, params, (batch,))

    return step
