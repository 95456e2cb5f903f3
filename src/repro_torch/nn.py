"""Layers the GNN and LM families share, the port of ``repro.nn``.

The reference keeps parameters as nested dicts and layers as pure
functions; here they are ``torch.nn`` modules whose attribute names are
the reference's dict keys, so a reference tree maps onto a
``state_dict`` key for key (``layer_i`` of an :class:`MLP`, ``scale`` and
``bias`` of a :class:`LayerNorm`; a :class:`Dense`'s ``w`` is stored
transposed as ``nn.Linear``'s ``weight``, see ``repro_torch.convert``).

Types promote as JAX promotes them: a :class:`Dense` computes in the
wider of its input's and its weight's dtype (a bfloat16 message times a
float32 weight is a float32 product), and :class:`LayerNorm` and
:class:`RMSNorm` take their statistics in float32 and return the
input's dtype. The LM layers write ``x @ w.astype(x.dtype)`` instead:
:class:`CastDense` casts its float32 weight to the input's dtype, so a
bfloat16 activation gives a bfloat16 product.

:func:`reset_parameters` draws the weights with the reference's scheme
(``N(0, 1/d_in)`` weights, or ``N(0, 1)·init_scale`` where a
:class:`CastDense` sets one; zero biases; unit LayerNorm scales, zero
RMSNorm scales) from an explicit ``torch.Generator``; a module with a
``reset_own(generator)`` method (the LM's embedding, the MoE experts)
draws its own tensors there. :func:`embed_init` is the reference's
``N(0, 0.02²)`` embedding. :func:`remat` is the families' per-layer
activation checkpointing.
"""

from __future__ import annotations

import math
from typing import Callable, Mapping, Optional, Sequence, Union

import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call
from torch.utils.checkpoint import checkpoint

from repro_torch.sharding import spmd

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


class CastDense(nn.Linear):
    """``x @ w.astype(x.dtype)`` without a bias (the LM's projections):
    the weight is cast to the input's dtype. ``init_scale`` replaces
    ``1/√d_in`` as the standard deviation of the initial weight (the MoE
    router's 0.02)."""

    def __init__(self, d_in: int, d_out: int,
                 init_scale: Optional[float] = None):
        super().__init__(d_in, d_out, bias=False)
        self.init_scale = init_scale

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return spmd.linear(x, self.weight.to(x.dtype))


class RMSNorm(nn.Module):
    """``x/√(mean(x²) + eps) · (1 + scale)`` over the last axis, in
    float32, returned in ``x``'s dtype; ``scale`` starts at zero."""

    def __init__(self, d: int, eps: float = 1e-6):
        super().__init__()
        self.scale = nn.Parameter(torch.zeros(d))
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        y = xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + self.eps)
        return (y * (1.0 + self.scale.float())).to(x.dtype)


def embed_init(vocab: int, d: int, generator: torch.Generator,
               device=None, dtype: torch.dtype = torch.float32
               ) -> torch.Tensor:
    """``N(0, 0.02²)`` of shape ``[vocab, d]``, drawn from ``generator``."""
    return torch.randn((vocab, d), generator=generator, device=device,
                       dtype=dtype) * 0.02


@torch.no_grad()
def reset_parameters(module: nn.Module, generator: torch.Generator) -> None:
    """The reference's initial values, drawn in module order from
    ``generator`` (on the parameters' device): every :class:`Dense`
    ``weight ~ N(0, 1/d_in)`` (a :class:`CastDense` with ``init_scale``:
    ``N(0, init_scale²)``) and ``bias = 0``; every :class:`LayerNorm`
    ``scale = 1``, ``bias = 0``; every :class:`RMSNorm` ``scale = 0``;
    and whatever a module's own ``reset_own(generator)`` draws."""
    for m in module.modules():
        if isinstance(m, nn.Linear):
            w = torch.randn(m.weight.shape, generator=generator,
                            device=m.weight.device, dtype=m.weight.dtype)
            scale = getattr(m, "init_scale", None)
            m.weight.copy_(w / math.sqrt(m.in_features) if scale is None
                           else w * scale)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, LayerNorm):
            m.scale.fill_(1.0)
            m.bias.zero_()
        elif isinstance(m, RMSNorm):
            m.scale.zero_()
        if hasattr(m, "reset_own"):
            m.reset_own(generator)


def remat(module: nn.Module, *inputs, extra: tuple = ()):
    """``module(*inputs, *extra)`` under activation checkpointing
    (``torch.utils.checkpoint``, non-reentrant): the backward recomputes
    it instead of keeping its activations. The module's parameters go in
    as inputs, so the recomputation runs over the same tensors even when
    the module was called through ``functional_call`` (whose
    substitution has ended by then)."""
    names, vals = zip(*module.named_parameters())
    n = len(inputs)

    def fn(*xs):
        return functional_call(module, dict(zip(names, xs[n:])),
                               (*xs[:n], *extra))

    return checkpoint(fn, *inputs, *vals, use_reentrant=False)


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
