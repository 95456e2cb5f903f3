"""Decoder-only transformer LM: RoPE, GQA, {SwiGLU | GeGLU | ReLU²}, MoE
option; the port of ``repro.models.transformer``.

The reference scans one stacked ``[L, …]`` parameter tree; here the model
is a :class:`Transformer` with one :class:`Block` per layer in an
``nn.ModuleList``, whose attribute names are the reference's keys
(``layers.{i}.wq.weight`` is ``layers["wq"][i]`` transposed, see
``repro_torch.convert.lm_state_from_reference``).

Numerics follow the reference: float32 parameters, each weight cast to
the activations' dtype where it is used (``cfg.dtype`` is the compute
dtype); RMSNorm, RoPE, the softmax statistics and the logits in float32;
attention probabilities cast to the compute dtype before the second
product; ``jax.nn.gelu``'s default tanh approximation in GeGLU. Where the
reference asks for ``preferred_element_type=float32`` (the scores, and
the chunked path's probabilities times values), :func:`matmul_f32` sums
the compute dtype's products into a float32 result, never rounding them
to bfloat16 first.

Attention is written in torch operations, as the reference writes it in
``jnp``: :func:`gqa_attention` materialises the ``[S, T]`` scores (up to
``_CHUNKED_ATTN_THRESHOLD`` tokens, and every decode step);
:func:`chunked_causal_attention` runs the online softmax over q blocks of
512 and kv blocks of 1024 (``cfg.attn_probs_bf16``: the ``exp`` in
bfloat16, ``m`` and ``l`` in float32), checkpointing each q block when
gradients are on, and skips the kv blocks that lie wholly above the
diagonal (exact: such a block adds ``exp(-1e30 - m) = 0``).

``cfg.remat`` checkpoints each layer (``torch.utils.checkpoint``, the
parameters passed in as inputs so that the recomputation runs over the
same tensors under ``functional_call``). Serving: :func:`prefill` runs
the prompt and returns its keys and values; :func:`prefill_into_cache`
copies them into a cache long enough for the decode steps;
:func:`decode_step` writes one token's keys and values into the cache in
place (the reference returns new arrays) and returns the same cache
tensors; :func:`generate` is the greedy or temperature loop.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.lm import TransformerConfig
from repro_torch.device import resolve_device
from repro_torch.models.moe import MoE
from repro_torch.nn import CastDense, RMSNorm, embed_init, remat
from repro_torch.sharding import lm as shard_lm
from repro_torch.sharding import spmd

# sequences at or below this use the plain (materialised) attention path
_CHUNKED_ATTN_THRESHOLD = 2048


def compute_dtype(cfg: TransformerConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


# ---------------------------------------------------------------------------
# rotary embeddings and attention
# ---------------------------------------------------------------------------

def rope_angles(positions: torch.Tensor, head_dim: int, theta: float):
    """``(cos, sin)`` [B, S, 1, hd/2] of RoPE at ``positions`` [B, S],
    float32."""
    half = head_dim // 2
    # log θ / half in float32, on the host: a scalar copied to the card
    # would synchronise the stream
    step = float(torch.log(torch.tensor(theta, dtype=torch.float32)) / half)
    freqs = torch.exp(-torch.arange(half, dtype=torch.float32,
                                    device=positions.device) * step)
    angles = positions[..., None].float() * freqs           # [B, S, half]
    return torch.cos(angles)[:, :, None, :], torch.sin(angles)[:, :, None, :]


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    half = x.shape[-1] // 2
    xf1, xf2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin], dim=-1)
    return out.to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """x: [B, S, H, hd]; positions: [B, S] (absolute). Float32 inside."""
    return apply_rope(x, *rope_angles(positions, x.shape[-1], theta))


class _MatmulF32(torch.autograd.Function):
    """Batched ``a @ b`` of bfloat16 (or float16) operands with a float32
    result. The card's ``bmm`` writes float32 itself (``out_dtype``); the
    CPU has no such ``bmm`` and multiplies float32 copies, which gives
    the same products (a product of two bfloat16 values is exact in
    float32). The backward runs in float32 and returns the operands'
    dtypes."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        if a.is_cuda:
            return torch.bmm(a, b, out_dtype=torch.float32)
        return torch.bmm(a.float(), b.float())

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        ga = gb = None
        if ctx.needs_input_grad[0]:
            ga = torch.bmm(g, b.float().mT).to(a.dtype)
        if ctx.needs_input_grad[1]:
            gb = torch.bmm(a.float().mT, g).to(b.dtype)
        return ga, gb


def matmul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a`` [N, m, k] @ ``b`` [N, k, n] -> float32 [N, m, n]: the
    operands' products summed in float32, the reference's
    ``preferred_element_type=float32``."""
    if a.dtype == b.dtype == torch.float32:
        return torch.bmm(a, b)
    return _MatmulF32.apply(a, b)


def attn_scores(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """q [B, S, KV, G, hd] · k [B, T, KV, hd] / √hd -> float32 scores
    [B, KV, G, S, T]."""
    B, S, KV, G, hd = q.shape
    T = k.shape[1]
    qm = q.permute(0, 2, 3, 1, 4).reshape(B * KV, G * S, hd)
    km = k.permute(0, 2, 3, 1).reshape(B * KV, hd, T)
    return matmul_f32(qm, km).view(B, KV, G, S, T) * (1.0 / math.sqrt(hd))


def gqa_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  mask: torch.Tensor) -> torch.Tensor:
    """q: [B,S,H,hd], k/v: [B,T,KV,hd], mask: [B,S,T] or broadcastable to
    the scores ``[B, KV, G, S, T]`` (the reference's ``[B,1,S,T]``).

    Grouped-query: H = KV * G; scores per (kv-head, group). Materialises
    [S, T] scores: for short S (decode: S = 1).
    """
    B, S, H, hd = q.shape
    KV = k.shape[2]
    q = q.reshape(B, S, KV, H // KV, hd)
    scores = attn_scores(q, k)
    m = mask[:, None, None] if mask.dim() == 3 else mask
    scores = torch.where(m, scores, -1e30)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bkgst,btkh->bskgh", probs, v)
    return out.reshape(B, S, H * hd)


def chunked_causal_attention(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor,
                             cfg: Optional[TransformerConfig] = None,
                             q_block: int = 512,
                             kv_block: int = 1024,
                             q_starts: Optional[Sequence[int]] = None
                             ) -> torch.Tensor:
    """Flash-style causal GQA: online softmax over KV blocks, one q block
    at a time; never materialises the [S, S] scores (peak per block
    [B, KV, G, qb, kb] float32).

    k and v hold the whole sequence; q holds ``nq`` blocks of
    ``q_block`` rows, block ``qi`` starting at absolute position
    ``q_starts[qi]`` (default ``qi · q_block``: q is the whole sequence
    too; a rank of the sequence-sharded attention holds a slice of every
    block)."""
    B, S, H, hd = q.shape
    T, KV = k.shape[1], k.shape[2]
    G = H // KV
    q_block, kv_block = min(q_block, S), min(kv_block, T)
    if S % q_block or T % kv_block:
        raise ValueError(f"S = {S}, T = {T} are not multiples of the "
                         f"blocks ({q_block}, {kv_block})")
    nq, nk = S // q_block, T // kv_block
    starts = (list(q_starts) if q_starts is not None
              else [qi * q_block for qi in range(nq)])
    qr = q.reshape(B, nq, q_block, KV, G, hd)
    kr = k.reshape(B, nk, kv_block, KV, hd)
    vr = v.reshape(B, nk, kv_block, KV, hd)
    probs_bf16 = cfg is not None and cfg.attn_probs_bf16
    q_pos = torch.arange(q_block, device=q.device)
    k_pos = torch.arange(kv_block, device=q.device)

    def q_step(qb, kr, vr, q0: int):
        m = torch.full((B, KV, G, q_block), -math.inf, device=q.device)
        l = torch.zeros((B, KV, G, q_block), device=q.device)
        acc = torch.zeros((B, KV, G, q_block, hd), device=q.device)
        # kv blocks wholly above the diagonal add nothing: skipped
        for ki in range(-(-(q0 + q_block) // kv_block)):
            kb, vb = kr[:, ki], vr[:, ki]
            s = attn_scores(qb, kb)
            valid = ((q0 + q_pos)[:, None]
                     >= (ki * kv_block + k_pos))
            s = torch.where(valid, s, -1e30)
            m_new = torch.maximum(m, s.amax(-1))
            if probs_bf16:
                p = torch.exp((s - m_new[..., None]).to(torch.bfloat16))
                l_inc = p.float().sum(-1)
            else:
                p = torch.exp(s - m_new[..., None])
                l_inc = p.sum(-1)
            corr = torch.exp(m - m_new)
            l = l * corr + l_inc
            pv = matmul_f32(
                p.to(vb.dtype).reshape(B * KV, G * q_block, kv_block),
                vb.permute(0, 2, 1, 3).reshape(B * KV, kv_block, hd))
            acc = acc * corr[..., None] + pv.view(B, KV, G, q_block, hd)
            m = m_new
        return (acc / l.clamp(min=1e-30)[..., None]).to(q.dtype)

    outs = []
    for qi in range(nq):
        if torch.is_grad_enabled():
            # the backward recomputes this q block's sweep instead of
            # keeping its score blocks
            outs.append(checkpoint(q_step, qr[:, qi], kr, vr, starts[qi],
                                   use_reentrant=False))
        else:
            outs.append(q_step(qr[:, qi], kr, vr, starts[qi]))
    out = torch.stack(outs, 1)                     # [B,nq,KV,G,qb,hd]
    return out.permute(0, 1, 4, 2, 3, 5).reshape(B, S, H * hd)


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mask,
           cfg: TransformerConfig, decode: bool = False) -> torch.Tensor:
    """The attention of one layer: the materialised path for decode and
    short sequences, the chunked path above the threshold (on a mesh,
    ``sharding.lm.attention`` runs it on each rank's tensors)."""
    if not decode and q.shape[1] > _CHUNKED_ATTN_THRESHOLD:
        return chunked_causal_attention(q, k, v, cfg)
    return gqa_attention(q, k, v, mask)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

class Block(nn.Module):
    """One layer: ``attn_norm``, ``wq``/``wk``/``wv``/``wo`` (and
    ``q_norm``/``k_norm``), ``ffn_norm`` and the FFN (``w_gate``,
    ``w_up``, ``w_down``; or ``moe``)."""

    def __init__(self, cfg: TransformerConfig):
        super().__init__()
        d, eps = cfg.d_model, cfg.norm_eps
        self.cfg = cfg
        self.attn_norm = RMSNorm(d, eps)
        self.ffn_norm = RMSNorm(d, eps)
        self.wq = CastDense(d, cfg.q_dim)
        self.wk = CastDense(d, cfg.kv_dim)
        self.wv = CastDense(d, cfg.kv_dim)
        self.wo = CastDense(cfg.q_dim, d)
        if cfg.qk_norm:
            self.q_norm = RMSNorm(cfg.head_dim, eps)
            self.k_norm = RMSNorm(cfg.head_dim, eps)
        if cfg.moe is not None:
            self.moe = MoE(cfg)
        else:
            if cfg.activation in ("swiglu", "geglu"):
                self.w_gate = CastDense(d, cfg.d_ff)
            elif cfg.activation != "relu2":
                raise ValueError(cfg.activation)
            self.w_up = CastDense(d, cfg.d_ff)
            self.w_down = CastDense(cfg.d_ff, d)

    def attn(self, h, positions, mask, kv=None):
        """Self-attention sublayer; ``kv = (cache_k, cache_v, cache_len)``
        (decode) writes this step's keys and values into the cache in
        place and attends over the whole cache."""
        cfg = self.cfg
        B, S, _ = h.shape
        x = shard_lm.batch_only(self.attn_norm(h), cfg)
        q = shard_lm.split_heads(self.wq(x), cfg.n_heads, cfg)
        k = shard_lm.split_heads(self.wk(x), cfg.n_kv_heads, cfg)
        v = shard_lm.split_heads(self.wv(x), cfg.n_kv_heads, cfg)
        if cfg.qk_norm:
            q, k = self.q_norm(q), self.k_norm(k)
        cos, sin = rope_angles(positions, cfg.head_dim, cfg.rope_theta)
        q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
        new_kv = (k, v)
        if kv is not None:
            cache_k, cache_v, n = kv
            shard_lm.write_cache(cache_k, k, n)
            shard_lm.write_cache(cache_v, v, n)
            new_kv = (cache_k, cache_v)
            attn = shard_lm.attention(q, cache_k, cache_v, mask, cfg,
                                      decode=True)
        else:
            attn = shard_lm.attention(q, k, v, mask, cfg)
        # the row-parallel partial sum reduced into the residual's layout
        # (a reduce-scatter under Megatron-SP)
        return h + shard_lm.constrain_batch(self.wo(attn), cfg), new_kv

    def ffn(self, h):
        cfg = self.cfg
        x = shard_lm.batch_only(self.ffn_norm(h), cfg)
        aux = torch.zeros((), dtype=torch.float32, device=h.device)
        if cfg.moe is not None:
            y, aux = self.moe(x)
        elif cfg.activation == "swiglu":
            y = self.w_down(F.silu(self.w_gate(x)) * self.w_up(x))
        elif cfg.activation == "geglu":
            y = self.w_down(F.gelu(self.w_gate(x), approximate="tanh")
                            * self.w_up(x))
        else:                                        # relu2
            u = F.relu(self.w_up(x))
            y = self.w_down(u * u)
        return h + shard_lm.constrain_batch(y, cfg), aux

    def forward(self, h, positions, mask, kv=None):
        h, new_kv = self.attn(h, positions, mask, kv)
        h = shard_lm.constrain_batch(h, self.cfg)
        h, aux = self.ffn(h)
        return shard_lm.constrain_batch(h, self.cfg), new_kv, aux


class Transformer(nn.Module):
    """``embed`` ``[V, d]``, ``layers`` (one :class:`Block` each),
    ``final_norm`` and, without tied embeddings, ``lm_head``."""

    def __init__(self, cfg: TransformerConfig):
        super().__init__()
        self.cfg = cfg
        self.embed = nn.Parameter(torch.zeros(cfg.vocab_size, cfg.d_model))
        self.layers = nn.ModuleList(Block(cfg) for _ in range(cfg.n_layers))
        self.final_norm = RMSNorm(cfg.d_model, cfg.norm_eps)
        if not cfg.tie_embeddings:
            self.lm_head = CastDense(cfg.d_model, cfg.vocab_size)

    @torch.no_grad()
    def reset_own(self, generator: torch.Generator) -> None:
        self.embed.copy_(embed_init(*self.embed.shape, generator,
                                    device=self.embed.device,
                                    dtype=self.embed.dtype))

    def _embed(self, tokens: torch.Tensor) -> torch.Tensor:
        return shard_lm.embedding(tokens, self.embed, self.cfg).to(
            compute_dtype(self.cfg))

    def _logits(self, h: torch.Tensor) -> torch.Tensor:
        h = self.final_norm(h)
        if self.cfg.tie_embeddings:
            return spmd.linear(h, self.embed.to(h.dtype)).float()
        return self.lm_head(h).float()

    def forward(self, tokens: torch.Tensor, return_cache: bool = False,
                last_only: bool = False):
        """tokens: [B, S] -> (logits [B, S, V] float32, aux) and, with
        ``return_cache``, ``(cache_k, cache_v)`` [L, B, S, KV, hd].

        ``last_only`` applies the head to the final position only
        (prefill: no [B, S, V] logits)."""
        with spmd.replicate_plain(self.embed):
            return self._forward(tokens, return_cache, last_only)

    def _forward(self, tokens, return_cache, last_only):
        B, S = tokens.shape
        h = shard_lm.constrain_batch(self._embed(tokens), self.cfg)
        positions = torch.arange(S, device=h.device).expand(B, S)
        causal = (torch.tril(torch.ones((S, S), dtype=torch.bool,
                                        device=h.device))[None, None]
                  if S <= _CHUNKED_ATTN_THRESHOLD else None)
        auxs, ks, vs = [], [], []
        for layer in self.layers:
            if self.cfg.remat and torch.is_grad_enabled():
                h, (k, v), aux = remat(layer, h, extra=(positions, causal))
            else:
                h, (k, v), aux = layer(h, positions, causal)
            auxs.append(aux)
            if return_cache:
                ks.append(k)
                vs.append(v)
        # a sequence-sharded residual gathered before the head (Megatron-SP)
        h = shard_lm.batch_only(h, self.cfg)
        if last_only:
            h = h[:, -1:]
        logits, aux_loss = self._logits(h), torch.stack(auxs).sum()
        if return_cache:
            return logits, aux_loss, (torch.stack(ks), torch.stack(vs))
        return logits, aux_loss

    def decode(self, token: torch.Tensor, cache_k: torch.Tensor,
               cache_v: torch.Tensor, cache_len: int):
        """See :func:`decode_step`."""
        with spmd.replicate_plain(self.embed):
            return self._decode(token, cache_k, cache_v, cache_len)

    def _decode(self, token, cache_k, cache_v, cache_len):
        B, T = token.shape[0], cache_k.shape[2]
        n = int(cache_len)
        # pinned as after the forward's embedding (a sharded embedding is a
        # partial sum over "model")
        h = shard_lm.constrain_batch(self._embed(token),           # [B, 1, d]
                                     self.cfg)
        positions = torch.full((B, 1), n, device=h.device)
        # attend to cache positions [0, cache_len]
        mask = (torch.arange(T, device=h.device) <= n)[None, None, None]
        for i, layer in enumerate(self.layers):
            h, _, _ = layer(h, positions, mask,
                            kv=(cache_k[i], cache_v[i], n))
        return self._logits(h), cache_k, cache_v


def loss_fn(model: Transformer, tokens: torch.Tensor, labels: torch.Tensor):
    """Token-mean cross entropy + the summed MoE aux losses:
    ``(loss, {"ce", "aux"})``."""
    logits, aux = model(tokens)
    ce = shard_lm.cross_entropy(logits, labels).mean()
    return ce + aux, {"ce": ce, "aux": aux}


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def init_cache(cfg: TransformerConfig, batch: int, max_len: int,
               dtype: Optional[torch.dtype] = None, device=None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Zero keys and values ``[L, batch, max_len, KV, hd]`` (the compute
    dtype unless ``dtype``) on ``device`` (``None``: the card)."""
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    dtype = dtype or compute_dtype(cfg)
    dev = resolve_device(device)
    return (torch.zeros(shape, dtype=dtype, device=dev),
            torch.zeros(shape, dtype=dtype, device=dev))


def prefill(model: Transformer, tokens: torch.Tensor,
            last_only: bool = False):
    """Run the prompt: ``(logits, (cache_k, cache_v))`` of prompt length."""
    logits, _, cache = model(tokens, return_cache=True, last_only=last_only)
    return logits, cache


def prefill_into_cache(cfg: TransformerConfig, prefill_fn: Callable,
                       tokens: torch.Tensor, max_len: int):
    """Run ``prefill_fn(tokens) -> (logits, (k, v))`` over the prompt
    [B, S] and copy its keys and values into positions ``[0, S)`` of a
    zero cache of ``max_len`` on the prompt's device: ``(logits,
    cache_k, cache_v)``, ready for :func:`decode_step` at
    ``cache_len = S``."""
    B, S = tokens.shape
    logits, (pk, pv) = prefill_fn(tokens)
    cache_k, cache_v = init_cache(cfg, B, max_len, device=tokens.device)
    cache_k[:, :, :S] = pk
    cache_v[:, :, :S] = pv
    return logits, cache_k, cache_v


def decode_step(model: Transformer, token: torch.Tensor,
                cache_k: torch.Tensor, cache_v: torch.Tensor,
                cache_len: int):
    """One decode step. token: [B, 1]; cache_[kv]: [L, B, T, KV, hd];
    ``cache_len`` tokens already in the cache. Writes this token's keys
    and values at ``cache_len`` in place; returns (logits [B, 1, V], the
    same caches)."""
    return model.decode(token, cache_k, cache_v, cache_len)


@torch.no_grad()
def generate(model: Transformer, prompt: torch.Tensor, n_steps: int,
             temperature: float = 0.0,
             generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Greedy (or, with ``temperature``, sampled from ``generator``)
    continuation of ``prompt`` [B, S]: ``n_steps`` tokens [B, n_steps]."""
    S = prompt.shape[1]
    logits, cache_k, cache_v = prefill_into_cache(
        model.cfg, lambda t: prefill(model, t), prompt, S + n_steps)
    tok = logits[:, -1:].argmax(-1).to(prompt.dtype)
    out = [tok]
    for i in range(n_steps - 1):
        logits, cache_k, cache_v = decode_step(model, tok, cache_k, cache_v,
                                               S + i)
        if temperature > 0:
            probs = torch.softmax(logits[:, -1] / temperature, dim=-1)
            tok = torch.multinomial(probs, 1, generator=generator)
        else:
            tok = logits[:, -1:].argmax(-1)
        tok = tok.to(prompt.dtype)
        out.append(tok)
    return torch.cat(out, dim=1)
