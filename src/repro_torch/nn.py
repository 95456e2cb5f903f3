"""Layers the GNN families share, the port of ``repro.nn``.

The reference keeps parameters as nested dicts and layers as pure
functions; here they are ``torch.nn`` modules whose attribute names are
the reference's dict keys, so a reference tree maps onto a
``state_dict`` key for key (``layer_i`` of an :class:`MLP`, ``scale`` and
``bias`` of a :class:`LayerNorm`; a :class:`Dense`'s ``w`` is stored
transposed as ``nn.Linear``'s ``weight``, see ``repro_torch.convert``).

Types promote as JAX promotes them: a :class:`Dense` computes in the
wider of its input's and its weight's dtype (a bfloat16 message times a
float32 weight is a float32 product), and :class:`LayerNorm` takes its
statistics in float32 and returns the input's dtype.

:func:`reset_parameters` draws the weights with the reference's scheme
(``N(0, 1/d_in)`` weights, zero biases, unit norm scales) from an
explicit ``torch.Generator``. ``rms_norm`` and ``embed_init`` belong to
the LM families (ROADMAP Queue 1 item 10).
"""

from __future__ import annotations

import math
from typing import Callable, Mapping, Sequence, Union

import torch
import torch.nn.functional as F
from torch import nn

ParamsLike = Union[nn.Module, Mapping[str, torch.Tensor]]


class Dense(nn.Linear):
    """``x @ w + b`` (``w`` kept as ``nn.Linear``'s ``[d_out, d_in]``)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = torch.promote_types(x.dtype, self.weight.dtype)
        b = None if self.bias is None else self.bias.to(dt)
        return F.linear(x.to(dt), self.weight.to(dt), b)


class MLP(nn.Module):
    """Dense layers ``layer_0 … layer_{k-1}`` over ``dims``, ``act`` between
    them (and after the last with ``final_act``)."""

    def __init__(self, dims: Sequence[int], bias: bool = True,
                 act: Callable = F.relu, final_act: bool = False):
        super().__init__()
        self.n = len(dims) - 1
        for i in range(self.n):
            self.add_module(f"layer_{i}", Dense(dims[i], dims[i + 1], bias))
        self.act, self.final_act = act, final_act

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.n):
            x = getattr(self, f"layer_{i}")(x)
            if i < self.n - 1 or self.final_act:
                x = self.act(x)
        return x


class LayerNorm(nn.Module):
    """``(x − μ)/√(σ² + eps) · scale + bias`` over the last axis, the
    statistics (biased variance) in float32, the output in ``x``'s dtype."""

    def __init__(self, d: int, eps: float = 1e-5):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(d))
        self.bias = nn.Parameter(torch.zeros(d))
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        mu = xf.mean(-1, keepdim=True)
        var = (xf - mu).square().mean(-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + self.eps)
        return (y * self.scale + self.bias).to(x.dtype)


@torch.no_grad()
def reset_parameters(module: nn.Module, generator: torch.Generator) -> None:
    """The reference's initial values, drawn in module order from
    ``generator`` (on the parameters' device): every :class:`Dense`
    ``weight ~ N(0, 1/d_in)`` and ``bias = 0``; every :class:`LayerNorm`
    ``scale = 1``, ``bias = 0``."""
    for m in module.modules():
        if isinstance(m, nn.Linear):
            w = torch.randn(m.weight.shape, generator=generator,
                            device=m.weight.device, dtype=m.weight.dtype)
            m.weight.copy_(w / math.sqrt(m.in_features))
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, LayerNorm):
            m.scale.fill_(1.0)
            m.bias.zero_()


def _leaves(params: ParamsLike):
    if isinstance(params, nn.Module):
        return [p for p in params.parameters()]
    return list(params.values())


def param_count(params: ParamsLike) -> int:
    """Entries over every parameter of a module or a dict of tensors."""
    return sum(x.numel() for x in _leaves(params))


def param_bytes(params: ParamsLike) -> int:
    return sum(x.numel() * x.element_size() for x in _leaves(params))


def tree_cast(params: ParamsLike, dtype: torch.dtype) -> ParamsLike:
    """Floating tensors cast to ``dtype``, the rest unchanged: a dict gives
    a new dict, a module is cast in place and returned."""
    if isinstance(params, nn.Module):
        for p in params.parameters():
            if p.is_floating_point():
                p.data = p.data.to(dtype)
        return params
    return {k: v.to(dtype) if v.is_floating_point() else v
            for k, v in params.items()}
