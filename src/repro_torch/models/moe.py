"""Mixture-of-Experts FFN with static-capacity sort-based dispatch, the
port of ``repro.models.moe``.

Top-k routing (float32) → sort the token-expert assignments by expert
(stable) → a static-capacity ``[E, C]`` table of token ids → batched
expert SwiGLU → gate-weighted ``index_add_`` back to the tokens.
Assignments past an expert's capacity are dropped (Switch/GShard
semantics; ``capacity_factor`` sets C): they go to a row ``E`` that is
cut off, and a padded slot points at token 0 with gate 0. Arctic's dense
residual FFN (``moe.dense_residual_d_ff``) is added to the routed output.

On a mesh (the activations DTensors, ``cfg.moe_shardmap_dispatch`` and
``cfg.batch_axes`` set) :func:`moe_ffn` takes :func:`moe_ffn_shardmap`,
the reference's expert-parallel ``shard_map`` dispatch written with
``local_map``: each rank routes its data shard locally and dispatches
only to the experts it owns. Where the reference's prerequisites fail
(no "model" axis, no data axis, ``E`` or ``B`` not divisible) it runs
the dense dispatch, as the reference does; on DTensors that dispatch
runs on replicated tensors, since its scatter and index ops have no
sharding strategy.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.nn import CastDense
from repro_torch.sharding import spmd
from repro_torch.sharding.rules import axis_sizes, to_placements


class MoE(nn.Module):
    """``router`` ``[E, d]`` (N(0, 0.02²)), the experts' ``w_gate`` and
    ``w_up`` ``[E, d, ff]`` (N(0, 1)/√d) and ``w_down`` ``[E, ff, d]``
    (N(0, 1)/√ff) in the reference's layout, and Arctic's ``dense_gate``,
    ``dense_up``, ``dense_down``."""

    def __init__(self, cfg):
        super().__init__()
        moe, d = cfg.moe, cfg.d_model
        e, ff = moe.n_experts, moe.d_ff_expert
        self.cfg = cfg
        self.router = CastDense(d, e, init_scale=0.02)
        self.w_gate = nn.Parameter(torch.zeros(e, d, ff))
        self.w_up = nn.Parameter(torch.zeros(e, d, ff))
        self.w_down = nn.Parameter(torch.zeros(e, ff, d))
        if moe.dense_residual_d_ff:
            dff = moe.dense_residual_d_ff
            self.dense_gate = CastDense(d, dff)
            self.dense_up = CastDense(d, dff)
            self.dense_down = CastDense(dff, d)

    @torch.no_grad()
    def reset_own(self, generator: torch.Generator) -> None:
        d, ff = self.w_gate.shape[1], self.w_down.shape[1]
        for w, fan_in in ((self.w_gate, d), (self.w_up, d),
                          (self.w_down, ff)):
            w.copy_(torch.randn(w.shape, generator=generator,
                                device=w.device, dtype=w.dtype)
                    / math.sqrt(fan_in))

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        return moe_ffn(self, x, self.cfg)


def capacity(n_tokens: int, moe) -> int:
    """Slots per expert: ``N·k·capacity_factor/E`` rounded up to 8, at
    least 8."""
    c = int(n_tokens * moe.top_k * moe.capacity_factor / moe.n_experts)
    return max(8, -(-c // 8) * 8)


def route(p: MoE, xt: torch.Tensor, moe):
    """``(logits, probs, gates, experts)`` of ``xt`` [N, d] in float32:
    the top-k experts in descending probability and their renormalised
    gates."""
    return _route(p.router.weight, xt, moe)


def _route(router_w: torch.Tensor, xt: torch.Tensor, moe):
    logits = F.linear(xt.float(), router_w.float())
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_idx = torch.topk(probs, moe.top_k, dim=-1)
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True)
    return logits, probs, gate_vals, expert_idx


def dispatch_table(expert_idx: torch.Tensor, gate_vals: torch.Tensor,
                   n_experts: int, cap: int, e_lo: int = 0,
                   n_local: Optional[int] = None):
    """The ``[E, C]`` token ids and gates of the sort-based dispatch, and
    the number of dropped assignments. With ``e_lo`` and ``n_local`` the
    table covers experts ``[e_lo, e_lo + n_local)`` only (a rank's block
    under expert parallelism), and counts only their drops."""
    n_local = n_experts if n_local is None else n_local
    N, K = expert_idx.shape
    dev = expert_idx.device
    flat_expert = expert_idx.reshape(-1)
    flat_token = torch.arange(N, device=dev).repeat_interleave(K)
    order = torch.argsort(flat_expert, stable=True)
    se, st, sg = flat_expert[order], flat_token[order], \
        gate_vals.reshape(-1)[order]
    starts = torch.searchsorted(se, torch.arange(n_experts, device=dev))
    pos_in_e = torch.arange(N * K, device=dev) - starts[se]
    local_e = se - e_lo
    in_block = (local_e >= 0) & (local_e < n_local)
    keep = in_block & (pos_in_e < cap)
    slot_e = torch.where(keep, local_e, n_local)  # overflow -> dropped row
    slot_c = torch.where(keep, pos_in_e, 0)
    # padded slots point at token 0 with gate 0
    dispatch = torch.zeros((n_local + 1, cap), dtype=torch.int64,
                           device=dev).index_put((slot_e, slot_c), st)
    gates = torch.zeros((n_local + 1, cap), dtype=torch.float32,
                        device=dev).index_put((slot_e, slot_c), sg)
    return dispatch[:n_local], gates[:n_local], in_block.sum() - keep.sum()


def _routed(router_w, w_gate, w_up, w_down, xt: torch.Tensor, moe,
            cap: int, e_lo: int = 0):
    """Routing, the aux losses and the dispatch of ``xt`` [N, d] to the
    experts ``[e_lo, e_lo + len(w_gate))``: ``(y [N, d], aux)``."""
    N, d = xt.shape
    E = moe.n_experts
    logits, probs, gate_vals, expert_idx = _route(router_w, xt, moe)

    # Switch load balance (over each token's first expert) + router z-loss
    me = probs.mean(0)
    # the mean of the first experts' one-hot rows (F.one_hot checks its
    # range on the host, a synchronisation)
    ce = torch.zeros(E, device=xt.device).scatter_add_(
        0, expert_idx[:, 0], torch.ones(N, device=xt.device)) / N
    lb_loss = E * torch.sum(me * ce) * moe.load_balance_loss
    z_loss = (torch.logsumexp(logits, -1) ** 2).mean() * moe.router_z_loss
    aux = lb_loss + z_loss

    n_local = w_gate.shape[0]
    dispatch, gates_ec, _ = dispatch_table(expert_idx, gate_vals, E, cap,
                                           e_lo, n_local)
    dtype = xt.dtype
    C = dispatch.shape[1]
    xe = xt.index_select(0, dispatch.reshape(-1)).reshape(n_local, C, d)
    hh = (F.silu(torch.bmm(xe, w_gate.to(dtype)))
          * torch.bmm(xe, w_up.to(dtype)))
    ye = torch.bmm(hh, w_down.to(dtype)) * gates_ec[..., None].to(dtype)
    y = torch.zeros((N, d), dtype=dtype, device=xt.device).index_add(
        0, dispatch.reshape(-1), ye.reshape(-1, d))
    return y, aux


def _dense_residual(p: MoE, xt: torch.Tensor) -> torch.Tensor:
    return p.dense_down(F.silu(p.dense_gate(xt)) * p.dense_up(xt))


def moe_ffn(p: MoE, x: torch.Tensor, cfg) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: [B, S, d] -> (y [B, S, d], aux_loss float32 scalar)."""
    moe = cfg.moe
    if spmd.is_dtensor(x):
        out = None
        if cfg.moe_shardmap_dispatch and cfg.batch_axes:
            out = moe_ffn_shardmap(p, x, cfg, x.device_mesh)
        return out if out is not None else _moe_ffn_replicated(p, x, cfg)
    B, S, d = x.shape
    N = B * S
    xt = x.reshape(N, d)
    y, aux = _routed(p.router.weight, p.w_gate, p.w_up, p.w_down, xt, moe,
                     capacity(N, moe))
    if moe.dense_residual_d_ff:
        y = y + _dense_residual(p, xt)
    return y.reshape(B, S, d), aux


def _moe_ffn_replicated(p: MoE, x, cfg):
    """The dense dispatch of DTensors, run on each rank over replicated
    copies (its scatter and index ops have no sharding strategy)."""
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor.experimental import local_map
    moe, mesh = cfg.moe, x.device_mesh
    B, S, d = x.shape
    rep = (Replicate(),) * mesh.ndim

    def block(router_w, wg, wu, wd, xb):
        y, aux = _routed(router_w, wg, wu, wd, xb.reshape(-1, d), moe,
                         capacity(B * S, moe))
        return y.reshape(xb.shape), aux

    y, aux = local_map(block, out_placements=(rep, rep),
                       in_placements=(rep,) * 5, device_mesh=mesh,
                       redistribute_inputs=True)(
        p.router.weight, p.w_gate, p.w_up, p.w_down, x)
    if moe.dense_residual_d_ff:
        y = y + _dense_residual(p, x.reshape(B * S, d)).reshape(B, S, d)
    return y, aux


def moe_ffn_shardmap(p: MoE, x: torch.Tensor, cfg, mesh):
    """Expert-parallel dispatch without cross-rank gathers, the
    reference's ``_moe_ffn_shardmap``; None where its prerequisites fail.

    Tokens shard over the data axes and replicate over "model"; the
    experts shard over "model" (``E_loc = E / n_model`` a rank). Each
    rank routes its tokens locally, takes only the assignments bound for
    its own experts (local capacity ``C_loc = max(8, ⌈⌈C / n_data⌉ / 8⌉
    · 8)``: Switch semantics per data shard, equal to the dense dispatch
    where nothing drops), runs those experts, ``index_add``s into a local
    ``[N_loc, d]`` and returns it as a partial sum over "model": one
    all-reduce over "model" combines the experts. ``aux`` is each data
    shard's, averaged over the data axes (reduced as an average over
    every axis: the same value, since "model" holds copies, and so each
    copy's gradient counts once). Then Arctic's dense residual.
    """
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    moe = cfg.moe
    B, S, d = x.shape
    N, E = B * S, moe.n_experts
    names = mesh.mesh_dim_names
    if "model" not in names:
        return None
    data_axes = tuple(a for a in cfg.batch_axes if a in names)
    if not data_axes:
        return None
    sizes = axis_sizes(mesh)
    n_data = math.prod(sizes[a] for a in data_axes)
    n_model = sizes["model"]
    if E % n_model != 0 or B % n_data != 0:
        return None
    E_loc = E // n_model
    C_loc = max(8, -(-capacity(N, moe) // n_data // 8) * 8)
    e_lo = mesh.get_local_rank("model") * E_loc

    def on(axes_pl, other):
        # placements: ``axes_pl`` on the data axes, ``other`` elsewhere
        return tuple(axes_pl if a in data_axes else other for a in names)

    rep = (Replicate(),) * mesh.ndim
    every_partial = (Partial(),) * mesh.ndim
    x_pl = on(Shard(0), Replicate())
    w_pl = to_placements(mesh, ("model", None, None))
    w_grad = tuple(Partial() if a in data_axes else p
                   for a, p in zip(names, w_pl))

    def block(router_w, wg, wu, wd, xb):
        y, aux = _routed(router_w, wg, wu, wd, xb.reshape(-1, d), moe,
                         C_loc, e_lo)
        return y.reshape(xb.shape), aux

    y, aux = local_map(
        block,
        out_placements=(on(Shard(0), Partial()),
                        (Partial("avg"),) * mesh.ndim),
        in_placements=(rep, w_pl, w_pl, w_pl, x_pl),
        in_grad_placements=(every_partial, w_grad, w_grad, w_grad,
                            on(Shard(0), Partial())),
        device_mesh=mesh, redistribute_inputs=True,
    )(p.router.weight, p.w_gate, p.w_up, p.w_down, x)
    y = spmd.reduce_partial(y)                       # the combine
    aux = spmd.reduce_partial(aux)
    if moe.dense_residual_d_ff:
        y = y + _dense_residual(p, x.reshape(N, d)).reshape(B, S, d)
    return y, aux
