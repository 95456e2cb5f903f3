"""Mixture-of-Experts FFN with static-capacity sort-based dispatch, the
port of ``repro.models.moe`` (its dense dispatch, ``_moe_ffn_dense``).

Top-k routing (float32) → sort the token-expert assignments by expert
(stable) → a static-capacity ``[E, C]`` table of token ids → batched
expert SwiGLU → gate-weighted ``index_add_`` back to the tokens.
Assignments past an expert's capacity are dropped (Switch/GShard
semantics; ``capacity_factor`` sets C): they go to a row ``E`` that is
cut off, and a padded slot points at token 0 with gate 0. Arctic's dense
residual FFN (``moe.dense_residual_d_ff``) is added to the routed output.

The reference's ``shard_map`` expert-parallel dispatch is a sharding
concern and waits for the sharding rules (ROADMAP Queue 1 item 10.3):
:func:`moe_ffn` always runs the dense dispatch, which is what the
reference runs whenever ``cfg.batch_axes`` is empty.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.nn import CastDense


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
    logits = p.router(xt.float())
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_idx = torch.topk(probs, moe.top_k, dim=-1)
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True)
    return logits, probs, gate_vals, expert_idx


def dispatch_table(expert_idx: torch.Tensor, gate_vals: torch.Tensor,
                   n_experts: int, cap: int):
    """The ``[E, C]`` token ids and gates of the sort-based dispatch, and
    the number of dropped assignments."""
    N, K = expert_idx.shape
    dev = expert_idx.device
    flat_expert = expert_idx.reshape(-1)
    flat_token = torch.arange(N, device=dev).repeat_interleave(K)
    order = torch.argsort(flat_expert, stable=True)
    se, st, sg = flat_expert[order], flat_token[order], \
        gate_vals.reshape(-1)[order]
    starts = torch.searchsorted(se, torch.arange(n_experts, device=dev))
    pos_in_e = torch.arange(N * K, device=dev) - starts[se]
    keep = pos_in_e < cap
    slot_e = torch.where(keep, se, n_experts)     # overflow -> dropped row E
    slot_c = torch.where(keep, pos_in_e, 0)
    # padded slots point at token 0 with gate 0
    dispatch = torch.zeros((n_experts + 1, cap), dtype=torch.int64,
                           device=dev).index_put((slot_e, slot_c), st)
    gates = torch.zeros((n_experts + 1, cap), dtype=torch.float32,
                        device=dev).index_put((slot_e, slot_c), sg)
    return dispatch[:n_experts], gates[:n_experts], N * K - keep.sum()


def moe_ffn(p: MoE, x: torch.Tensor, cfg) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: [B, S, d] -> (y [B, S, d], aux_loss float32 scalar)."""
    moe = cfg.moe
    B, S, d = x.shape
    N, E = B * S, moe.n_experts
    xt = x.reshape(N, d)
    logits, probs, gate_vals, expert_idx = route(p, xt, moe)

    # Switch load balance (over each token's first expert) + router z-loss
    me = probs.mean(0)
    # the mean of the first experts' one-hot rows (F.one_hot checks its
    # range on the host, a synchronisation)
    ce = torch.zeros(E, device=x.device).scatter_add_(
        0, expert_idx[:, 0], torch.ones(N, device=x.device)) / N
    lb_loss = E * torch.sum(me * ce) * moe.load_balance_loss
    z_loss = (torch.logsumexp(logits, -1) ** 2).mean() * moe.router_z_loss
    aux = lb_loss + z_loss

    dispatch, gates_ec, _ = dispatch_table(expert_idx, gate_vals, E,
                                           capacity(N, moe))
    dtype = x.dtype
    C = dispatch.shape[1]
    xe = xt.index_select(0, dispatch.reshape(-1)).reshape(E, C, d)
    hh = (F.silu(torch.bmm(xe, p.w_gate.to(dtype)))
          * torch.bmm(xe, p.w_up.to(dtype)))
    ye = torch.bmm(hh, p.w_down.to(dtype)) * gates_ec[..., None].to(dtype)
    y = torch.zeros((N, d), dtype=dtype, device=x.device).index_add(
        0, dispatch.reshape(-1), ye.reshape(-1, d))

    if moe.dense_residual_d_ff:
        y = y + p.dense_down(F.silu(p.dense_gate(xt)) * p.dense_up(xt))
    return y.reshape(B, S, d), aux
