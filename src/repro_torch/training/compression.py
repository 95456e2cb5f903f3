"""Gradient compression for the data-parallel all-reduce, the port of
``repro.training.compression``.

An int8 all-reduce with one shared scale and error feedback:
  1. the max of ``|g + error|`` over the slots gives the scale;
  2. each slot rounds ``(g + error) / scale`` to int8 (half to even,
     clipped to ±127), and the int8 words are summed in int32;
  3. the sum is dequantised; each slot keeps its own rounding residual
     and adds it to its next gradient (error feedback).

The payload is a quarter of float32's. Collectives are single-controller,
as the sharded rows' combines are (``core/ops_sharded.py``): one process
holds every slot's tensor, ``xs[i]`` on slot ``i``'s device (slots may
repeat one card, or be the CPU), and the max and the int32 sum are
copies to the first slot and back. The operations run in the
reference's order, each its own elementwise pass, so the sums and the
residuals equal the reference's bit for bit (run op by op; under ``jit``
XLA may fuse ``xc − q·scale`` and round it once).
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch

Tensors = Dict[str, torch.Tensor]


def _all_reduce(vals: Sequence[torch.Tensor], op) -> List[torch.Tensor]:
    """``op`` over the slots' tensors on the first slot, the result copied
    back to each slot's device."""
    total = vals[0]
    for v in vals[1:]:
        total = op(total, v.to(total.device))
    return [total.to(v.device) for v in vals]


def compressed_psum(xs: Sequence[torch.Tensor], errors: Sequence[torch.Tensor]
                    ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """The approximate sum of ``xs`` over the slots with int8 payload.

    ``errors[i]`` is slot ``i``'s residual from the previous step (zeros
    at first). Returns ``(sums, new_errors)``: each slot's copy of the
    sum estimate and its own new residual, on its device, in ``xs``'s
    dtype.
    """
    if len(xs) != len(errors) or not xs:
        raise ValueError(f"{len(xs)} inputs for {len(errors)} residuals")
    xc = [x + e for x, e in zip(xs, errors)]
    gmax = _all_reduce([v.abs().max() for v in xc], torch.maximum)
    # a 0-d tensor on the slot's device divides exactly: the card turns a
    # division by a host scalar into a product with its reciprocal
    scales = [torch.clamp(m, min=1e-12) / torch.full_like(m, 127.0)
              for m in gmax]
    qs = [torch.clamp(torch.round(v / s), -127, 127).to(torch.int8)
          for v, s in zip(xc, scales)]
    totals = _all_reduce([q.to(torch.int32) for q in qs], torch.add)
    sums = [(t.to(torch.float32) * s).to(x.dtype)
            for t, s, x in zip(totals, scales, xs)]
    errs = [(v - q.to(torch.float32) * s).to(x.dtype)
            for v, q, s, x in zip(xc, qs, scales, xs)]
    return sums, errs


def compressed_psum_tree(grads: Sequence[Tensors], errors: Sequence[Tensors]
                         ) -> Tuple[List[Tensors], List[Tensors]]:
    """:func:`compressed_psum` of each named tensor: ``grads[i]`` and
    ``errors[i]`` are slot ``i``'s dicts, with the same names."""
    sums: List[Tensors] = [{} for _ in grads]
    errs: List[Tensors] = [{} for _ in grads]
    for k in grads[0]:
        s, e = compressed_psum([g[k] for g in grads], [e[k] for e in errors])
        for i in range(len(grads)):
            sums[i][k], errs[i][k] = s[i], e[i]
    return sums, errs


def topk_compress(g: torch.Tensor, k_frac: float = 0.01
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k sparsification: ``(kept, rest)``, ``kept`` the ``k = max(1,
    int(n·k_frac))`` entries of largest magnitude (the rest zeroed) and
    ``rest = g − kept``. Ties go to the lower index, as ``lax.top_k``'s
    do: a stable descending sort of ``|g|``, not ``torch.topk``, which
    promises no order among ties."""
    flat = g.reshape(-1)
    k = max(1, int(flat.shape[0] * k_frac))
    idx = torch.sort(flat.abs(), descending=True, stable=True).indices[:k]
    mask = torch.zeros_like(flat).index_fill_(0, idx, 1.0)
    kept = flat * mask
    return kept.reshape(g.shape), (flat - kept).reshape(g.shape)
