"""Embedding lookups and bags, the port of
``repro.models.recsys.embedding``.

Each function returns what the reference returns for the same inputs,
edge cases included, and none reads a value back to the host:

- a lookup is ``jnp.take`` in its fill mode: an id in ``[-n, n)`` of a
  table of ``n`` rows gives its row (a negative id counts from the end),
  any other id a row of the fill value (NaN for a float table, the least
  value for a signed integer one, the greatest for an unsigned one, True
  for bool). ``index_select`` would raise on the CPU and assert on the
  card, so the ids are clamped and the fill written with a ``where``;
- a bag's ids are ``searchsorted(offsets, arange(nnz), right) − 1``: ids
  before ``offsets[0]`` fall in bag −1 and, like any id of a bag outside
  ``[0, n_bags)``, count nowhere (torch's bags need ``offsets[0] == 0``);
- an empty bag sums to 0, has mean 0 and max −inf (torch's ``max`` bag
  gives 0);
- ``weights`` scale the rows in every mode, and ``mean`` still divides by
  the count, not by the weights' sum (torch takes
  ``per_sample_weights`` only with ``sum``).

So ``F.embedding_bag`` is not used. The sums are ``index_add`` and the
maxima ``scatter_reduce("amax")`` into one spare row that collects the
ids of no bag. Gradients are dense, as ``jax.grad`` of ``jnp.take``
gives them.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def _fill_value(dtype: torch.dtype):
    if dtype.is_floating_point:
        return float("nan")
    if dtype == torch.bool:
        return True
    info = torch.iinfo(dtype)
    return info.min if info.min < 0 else info.max


def embedding_lookup(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Plain gather from a ``[n, d]`` table: ids ``[...]`` -> ``[..., d]``,
    ``jnp.take``'s fill mode (see the module doc)."""
    n = table.shape[0]
    ids = ids.long()
    valid = (ids >= -n) & (ids < n)
    rows = F.embedding(torch.where(valid, torch.where(ids < 0, ids + n, ids),
                                   0), table)
    fill = torch.full((), _fill_value(table.dtype), dtype=table.dtype,
                      device=table.device)
    return torch.where(valid[..., None], rows, fill)


def embedding_bag(table: torch.Tensor, ids: torch.Tensor,
                  offsets: torch.Tensor, n_bags: int, mode: str = "sum",
                  weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``torch.nn.EmbeddingBag`` over a flat ragged id list, with the
    reference's semantics (see the module doc).

    ids: ``[nnz]``; offsets: ``[n_bags]`` (bag start positions, sorted).
    """
    if mode not in ("sum", "mean", "max"):
        raise ValueError(mode)
    nnz = ids.shape[0]
    pos = torch.arange(nnz, device=ids.device)
    bag = torch.searchsorted(offsets.long().contiguous(), pos,
                             right=True) - 1
    # ids of no bag go to the spare row n_bags, dropped at the end
    bag = torch.where((bag >= 0) & (bag < n_bags), bag, n_bags)
    emb = embedding_lookup(table, ids)
    if weights is not None:
        emb = emb * weights[:, None]
    shape = (n_bags + 1,) + emb.shape[1:]
    if mode == "max":
        idx = bag[:, None].expand_as(emb)
        return torch.full(shape, -torch.inf, dtype=emb.dtype,
                          device=emb.device).scatter_reduce(
            0, idx, emb, "amax", include_self=True)[:n_bags]
    s = torch.zeros(shape, dtype=emb.dtype, device=emb.device).index_add(
        0, bag, emb)[:n_bags]
    if mode == "sum":
        return s
    cnt = torch.zeros(n_bags + 1, dtype=emb.dtype, device=emb.device
                      ).index_add(0, bag, torch.ones_like(bag, dtype=emb.dtype)
                                  )[:n_bags]
    return s / torch.clamp(cnt, min=1.0)[:, None]


def embedding_bag_padded(table: torch.Tensor, ids: torch.Tensor,
                         mask: torch.Tensor, mode: str = "sum"
                         ) -> torch.Tensor:
    """Padded-batch variant: ids ``[B, L]`` with mask ``[B, L]``."""
    if mode not in ("sum", "mean"):
        raise ValueError(mode)
    emb = embedding_lookup(table, ids) * mask[..., None].to(table.dtype)
    s = emb.sum(1)
    if mode == "sum":
        return s
    cnt = mask.sum(1, keepdim=True).to(table.dtype)
    return s / torch.clamp(cnt, min=1.0)
