"""Optimizers as functions over a dict of named parameters: AdamW
(optionally with bfloat16 moments, updated in float32) and SGD with
momentum, under a linear-warmup cosine schedule.

The port of ``repro.training.optimizer``. ``update`` keeps the
reference's order, so the floats stay comparable: clip by the global
norm, ``step + 1``, the schedule, the bias-corrected moments, then
``p − lr·(δ + wd·p)``. ``torch.optim.AdamW`` cannot stand in: it keeps
its moments in the parameter's dtype and applies the decay in another
order. Parameters and gradients are dicts ``name -> tensor`` (a model's
``named_parameters``); ``update`` returns new tensors and leaves its
arguments as they were.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, NamedTuple, Optional, Tuple

import torch

Tensors = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    name: str = "adamw"               # adamw | sgd
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    momentum: float = 0.9             # sgd
    grad_clip: float = 1.0
    moment_dtype: str = "float32"     # float32 | bfloat16
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


class OptState(NamedTuple):
    step: torch.Tensor                # int32 scalar, on the parameters' device
    m: Tensors
    v: Optional[Tensors]              # None for sgd


_MOMENT_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def init(cfg: OptimizerConfig, params: Tensors) -> OptState:
    """Zero moments in ``cfg.moment_dtype`` and step 0."""
    dtype = _MOMENT_DTYPES[cfg.moment_dtype]

    def zeros():
        return {k: torch.zeros(p.shape, dtype=dtype, device=p.device)
                for k, p in params.items()}

    dev = next(iter(params.values())).device
    return OptState(step=torch.zeros((), dtype=torch.int32, device=dev),
                    m=zeros(), v=zeros() if cfg.name == "adamw" else None)


def lr_at(cfg: OptimizerConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup then cosine decay to ``min_lr_frac`` (float32)."""
    step = torch.as_tensor(step)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    frac = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * cos
    return cfg.lr * warm * frac


def clip_by_global_norm(grads: Tensors,
                        max_norm: float) -> Tuple[Tensors, torch.Tensor]:
    """Scale every gradient by ``min(1, max_norm / ‖grads‖)``; returns the
    scaled gradients and the norm before scaling (float32)."""
    gn = torch.sqrt(sum(torch.sum(torch.square(g.float()))
                        for g in grads.values()))
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-6), max=1.0)
    return {k: (g.float() * scale).to(g.dtype)
            for k, g in grads.items()}, gn


@torch.no_grad()
def update(cfg: OptimizerConfig, grads: Tensors, state: OptState,
           params: Tensors) -> Tuple[Tensors, OptState, Tensors]:
    """One optimizer step: ``(new params, new state, {"lr", "grad_norm"})``."""
    grads, gnorm = clip_by_global_norm(grads, cfg.grad_clip)
    step = state.step + 1
    lr = lr_at(cfg, step)
    metrics = {"lr": lr, "grad_norm": gnorm}
    new_p, new_m = {}, {}
    if cfg.name == "adamw":
        b1, b2 = cfg.beta1, cfg.beta2
        new_v = {}
        for k, p in params.items():
            gf = grads[k].float()
            m, v = state.m[k], state.v[k]
            mf = m.float() * b1 + gf * (1 - b1)
            vf = v.float() * b2 + gf * gf * (1 - b2)
            mhat = mf / (1 - b1 ** step)
            vhat = vf / (1 - b2 ** step)
            delta = mhat / (torch.sqrt(vhat) + cfg.eps)
            pf = p.float()
            pf = pf - lr * (delta + cfg.weight_decay * pf)
            new_p[k], new_m[k], new_v[k] = (pf.to(p.dtype), mf.to(m.dtype),
                                            vf.to(v.dtype))
        return new_p, OptState(step, new_m, new_v), metrics
    if cfg.name == "sgd":
        for k, p in params.items():
            gf = grads[k].float()
            m = state.m[k]
            mf = m.float() * cfg.momentum + gf
            pf = p.float() - lr * (mf + cfg.weight_decay * p.float())
            new_p[k], new_m[k] = pf.to(p.dtype), mf.to(m.dtype)
        return new_p, OptState(step, new_m, None), metrics
    raise ValueError(f"unknown optimizer {cfg.name!r} (adamw | sgd)")
