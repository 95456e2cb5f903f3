"""Binarization for BitGNN layers: STE, α scales, activation packing.

Training side: ``ste_sign`` and ``ste_step`` are the clipped
straight-through estimators (Bengio et al.; XNOR-Net): the forward is the
hard quantizer, the backward passes the incoming gradient where
``|x| <= 1`` and zeroes it elsewhere. Each is a
``torch.autograd.Function``; the reference writes the same rule as a
``jax.custom_vjp`` in plain jnp (there is no kernel on either side).

Inference side: ``pack_activations`` packs a binarized activation matrix
into ``BitMatrix`` words through the packing kernel
(``kernels/bitpack``), and ``alpha_scale`` is the per-feature scale
α_j = mean|x_j|, so that ``α · (A @ bits)`` approximates ``A @ x`` (exact
when x is already binary; XNOR-style otherwise).
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.core.operands import BitMatrix
from repro_torch.kernels.bitpack import ops as bitpack_ops


def _clipped(ctx, g: torch.Tensor) -> torch.Tensor:
    """The clipped STE backward: ``g · (|x| <= 1)``."""
    (x,) = ctx.saved_tensors
    return g * (x.abs() <= 1.0).to(g.dtype)


class _SteSign(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: torch.Tensor) -> torch.Tensor:
        ctx.save_for_backward(x)
        return torch.where(x >= 0, 1.0, -1.0).to(x.dtype)

    backward = staticmethod(_clipped)


class _SteStep(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: torch.Tensor) -> torch.Tensor:
        ctx.save_for_backward(x)
        return (x > 0).to(x.dtype)

    backward = staticmethod(_clipped)


def ste_sign(x: torch.Tensor) -> torch.Tensor:
    """Hard ±1 quantizer (``x >= 0`` -> +1) with a clipped STE gradient."""
    return _SteSign.apply(x)


def ste_step(x: torch.Tensor) -> torch.Tensor:
    """Hard {0, 1} threshold (``x > 0``) with the same clipped gradient."""
    return _SteStep.apply(x)


def alpha_scale(x: torch.Tensor, axis: int = 0) -> torch.Tensor:
    """Per-feature reconstruction scale α = mean|x| along ``axis``."""
    return x.abs().mean(dim=axis)


def binarize(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(±1 STE binarization of ``x``, per-feature α): the XNOR pair;
    ``xb * alpha[None, :]`` is the rank-1 reconstruction that the bit
    aggregation computes through α·popcount."""
    return ste_sign(x), alpha_scale(x)


def pack_activations(x: torch.Tensor, tile_dim: int) -> BitMatrix:
    """Binarize (``x > 0``) and pack activations into ``BitMatrix`` words
    through the packing kernel. The threshold is strict, so for ±1
    inputs the 1-bits are the +1 entries, which the ``2·counts − rowsum``
    reconstruction of ``layers.signed_aggregate`` assumes
    (``pack_columns`` and ``BitMatrix.pack`` binarize with ``!= 0``)."""
    words = bitpack_ops.pack_columns(x > 0, tile_dim)
    return BitMatrix.from_words(words, int(x.shape[0]), tile_dim)
