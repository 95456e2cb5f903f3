"""The LM's operations on a mesh: one function per operation the
transformer shards, each taking plain tensors or DTensors.

On plain tensors each runs the single-device operation (the attention
of ``models.transformer``, ``F.embedding``, ``torch.logsumexp``, a slice
assignment), so the model calls these and holds no sharded variant of
its own. On DTensors:

- :func:`constrain_batch` / :func:`batch_only` pin the residual stream's
  layout (the reference's ``_constrain_batch``, with its Megatron-SP
  case);
- :func:`attention` computes on each rank's local tensors
  (``local_map``): heads over "model", the sequence-sharded q blocks of
  ``attn_seq_shard``, replicated q/k/v, or the split-KV decode over a
  cache sharded by sequence;
- :func:`embedding` and :func:`cross_entropy` are vocabulary-parallel:
  the table and the logits stay sharded over "model" by vocab rows;
- :func:`write_cache` writes a step's keys and values on the rank that
  holds their positions.

The expert-parallel MoE is ``models.moe.moe_ffn_shardmap``, where the
reference has it.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.sharding import spmd

# below: ``cfg`` is a ``repro_torch.configs.lm.TransformerConfig``


def heads_uneven(cfg) -> bool:
    """Whether ``tp_width`` leaves the q or kv heads undivided."""
    return cfg.tp_width > 0 and (cfg.n_heads % cfg.tp_width != 0
                                 or cfg.n_kv_heads % cfg.tp_width != 0)


def constrain_batch(x: torch.Tensor, cfg) -> torch.Tensor:
    """Pin a residual-stream DTensor's batch dim to the data axes,
    replicated over "model" (the reference's ``with_sharding_constraint``;
    without it DTensor meets a ``Partial`` embedding in RMSNorm's mean).
    With ``cfg.seq_parallel_residual`` and heads that ``tp_width`` does
    not divide, the sequence dim also shards over "model" (Megatron-SP,
    paired with the sequence-sharded attention). A plain tensor passes
    as it is."""
    if not cfg.batch_axes or not spmd.is_dtensor(x):
        return x
    ba = tuple(cfg.batch_axes)
    if (cfg.seq_parallel_residual and heads_uneven(cfg)
            and x.dim() >= 3 and x.shape[1] > 1):
        return spmd.constrain(x, (ba, "model", *([None] * (x.dim() - 2))))
    return spmd.constrain(x, (ba, *([None] * (x.dim() - 1))))


def batch_only(x: torch.Tensor, cfg) -> torch.Tensor:
    """A [B, S, d] DTensor with its batch over the data axes, replicated
    over "model"; a plain tensor as it is. A sublayer's input goes
    through it: a sequence-sharded residual (Megatron-SP) is gathered
    once there, where DTensor would gather it again for each
    projection."""
    if not cfg.batch_axes or not spmd.is_dtensor(x):
        return x
    return spmd.constrain(x, (tuple(cfg.batch_axes), None, None))


def split_heads(t: torch.Tensor, n_heads: int, cfg) -> torch.Tensor:
    """[B, S, n·hd] -> [B, S, n, hd]. Heads that "model" does not divide
    are first replicated over it (DTensor cannot split a dim sharded
    unevenly)."""
    B, S, _ = t.shape
    if heads_uneven(cfg):
        t = batch_only(t, cfg)
    return t.reshape(B, S, n_heads, cfg.head_dim)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mask,
              cfg, decode: bool = False) -> torch.Tensor:
    """One layer's attention: ``models.transformer.attend`` on plain
    tensors, :func:`sharded_attention` on DTensors."""
    from repro_torch.models import transformer as T
    if spmd.is_dtensor(q):
        return sharded_attention(q, k, v, mask, cfg, decode)
    return T.attend(q, k, v, mask, cfg, decode)


def _layout(mesh, cfg, model):
    """Placements: the batch dim over the data axes, ``model`` on
    "model" (dims of a [B, S, …] tensor)."""
    from torch.distributed.tensor import Replicate, Shard
    return tuple(Shard(0) if a in cfg.batch_axes
                 else model if a == "model" else Replicate()
                 for a in mesh.mesh_dim_names)


def sharded_attention(q, k, v, mask, cfg, decode: bool = False):
    """The attention over DTensors q [B, S, H, hd] and k, v [B, T, KV,
    hd], each rank computing on its own tensors (``local_map``), so no
    attention op meets DTensor's sharding propagation:

    - decode: the cache's sequence is sharded over "model"
      (``rules.lm_cache_specs``); each rank attends over its slice and
      the slices' softmax statistics combine (split-KV, flash-decoding);
    - heads that "model" divides: each rank takes its heads;
    - otherwise, above the chunked threshold with ``attn_seq_shard``:
      each rank takes a slice of every q block (the reference's
      ``P(batch, None, "model")`` on the blocks: causal work balanced)
      against replicated k and v;
    - otherwise q, k and v replicate over "model".

    ``mask`` is the plain tensor of the unsharded path (or None)."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from repro_torch.models import transformer as T
    mesh = q.device_mesh
    B, S, H, hd = q.shape
    j, n = spmd.model_rank(mesh)
    rep = _layout(mesh, cfg, Replicate())

    if decode:
        return _split_kv_decode(q, k, v, mask, cfg, mesh, j)
    if not heads_uneven(cfg) and cfg.tp_width == n and n > 1:
        heads = _layout(mesh, cfg, Shard(2))
        return spmd.local(lambda q, k, v: T.attend(q, k, v, mask, cfg),
                          heads, (heads, heads, heads), mesh, q, k, v)
    q_block = min(512, S)
    if (S > T._CHUNKED_ATTN_THRESHOLD and cfg.attn_seq_shard and n > 1
            and q_block % n == 0):
        nq, qb = S // q_block, q_block // n
        blocks = _layout(mesh, cfg, Shard(2))

        def run(q5, k, v):
            out = T.chunked_causal_attention(
                q5.reshape(q5.shape[0], nq * qb, H, hd), k, v, cfg,
                q_block=qb, q_starts=[i * q_block + j * qb
                                      for i in range(nq)])
            return out.reshape(out.shape[0], nq, qb, H * hd)

        # each rank's q slice gives a part of k's and v's gradients
        part = _layout(mesh, cfg, Partial())
        out = spmd.local(run, blocks, (blocks, rep, rep), mesh,
                         q.reshape(B, nq, q_block, H, hd), k, v,
                         in_grad_placements=(blocks, part, part))
        return spmd.constrain(out, (tuple(cfg.batch_axes),)).reshape(
            B, S, H * hd)
    return spmd.local(lambda q, k, v: T.attend(q, k, v, mask, cfg), rep,
                      (rep, rep, rep), mesh, q, k, v)


def _split_kv_decode(q, k, v, mask, cfg, mesh, j: int):
    """Decode over a cache whose sequence is sharded over "model": each
    rank's max, sum of exps and unnormalised output over its slice,
    combined as the reference's split-KV (one all-reduce each)."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    from repro_torch.models import transformer as T
    B, S, H, hd = q.shape
    KV = k.shape[2]
    rep = _layout(mesh, cfg, Replicate())
    seq = _layout(mesh, cfg, Shard(1))
    stacked = tuple(Shard(0) if a == "model" else
                    (Shard(1) if a in cfg.batch_axes else Replicate())
                    for a in mesh.mesh_dim_names)

    def part(q, k, v):
        lo = j * k.shape[1]
        s = T.attn_scores(q.reshape(q.shape[0], S, KV, H // KV, hd), k)
        s = torch.where(mask[..., lo:lo + k.shape[1]], s, -1e30)
        m = s.amax(-1)                                # [B, KV, G, S]
        p = torch.exp(s - m[..., None])
        acc = torch.einsum("bkgst,btkh->bkgsh", p.to(q.dtype), v).float()
        return m[None], p.sum(-1)[None], acc[None]

    m, l, acc = local_map(part, out_placements=(stacked,) * 3,
                          in_placements=(rep, seq, seq), device_mesh=mesh,
                          redistribute_inputs=True)(q, k, v)
    m_all = spmd.reduce_partial(m.amax(0))
    w = torch.exp(m - m_all)
    l_all = spmd.reduce_partial((w * l).sum(0))
    acc_all = spmd.reduce_partial((w[..., None] * acc).sum(0))
    out = (acc_all / l_all[..., None]).to(q.dtype)    # [B, KV, G, S, hd]
    return out.permute(0, 3, 1, 2, 4).reshape(B, S, H * hd)


def write_cache(cache: torch.Tensor, new: torch.Tensor, n: int) -> None:
    """``cache[:, n:n + S] = new`` in place (cache [B, T, KV, hd], new
    [B, S, KV, hd]). A DTensor cache sharded over its sequence is written
    by the rank that holds the positions (the reference's local masked
    update)."""
    if not spmd.is_dtensor(cache):
        cache[:, n:n + new.shape[1]] = new
        return
    from torch.distributed.tensor import Replicate, Shard
    mesh = cache.device_mesh
    j, _ = spmd.model_rank(mesh)
    # new: the cache's batch sharding, replicated over the sequence's axis
    new_pl = tuple(p if p == Shard(0) else Replicate()
                   for p in cache.placements)

    def write(c, x):
        lo = n - j * c.shape[1]
        if 0 <= lo < c.shape[1]:
            c[:, lo:lo + x.shape[1]] = x
        return c

    spmd.local(write, cache.placements, (cache.placements, new_pl), mesh,
               cache, new)


# ---------------------------------------------------------------------------
# the vocabulary: embedding and cross entropy
# ---------------------------------------------------------------------------

def _vocab_lo(mesh, V: int) -> int:
    """The first vocab row of this rank's block over "model"."""
    j, n = spmd.model_rank(mesh)
    return j * -(-V // n)


def embedding(tokens: torch.Tensor, table: torch.Tensor, cfg
              ) -> torch.Tensor:
    """``table[tokens]``. A DTensor table [V, d] is sharded over "model"
    by vocab rows and gathered over the data axes, the tokens by batch
    over the data axes; each rank looks up the tokens in its rows and the
    result is a partial sum over "model" (DTensor's own masked lookup
    cannot take a partial gradient in its backward)."""
    if not spmd.is_dtensor(table):
        return F.embedding(tokens.long(), table)
    from torch.distributed.tensor import Partial, Replicate, Shard
    mesh = table.device_mesh
    lo = _vocab_lo(mesh, table.shape[0])

    def look(t, w):
        idx = t.long() - lo
        inside = (idx >= 0) & (idx < w.shape[0])
        e = F.embedding(idx.clamp(0, w.shape[0] - 1), w)
        return torch.where(inside[..., None], e,
                           torch.zeros((), dtype=e.dtype))

    names = mesh.mesh_dim_names
    batch = tuple(Shard(0) if a in cfg.batch_axes else Replicate()
                  for a in names)
    rows = tuple(Shard(0) if a == "model" else Replicate() for a in names)
    out = tuple(Partial() if a == "model" else p
                for a, p in zip(names, batch))
    # the data axes' ranks look up different tokens: partial gradients
    rows_grad = tuple(Partial() if a in cfg.batch_axes else p
                      for a, p in zip(names, rows))
    return spmd.local(look, out, (batch, rows), mesh,
                      spmd.as_dtensor(tokens, mesh), table,
                      in_grad_placements=(batch, rows_grad))


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor
                  ) -> torch.Tensor:
    """Each position's ``logsumexp(logits) - logits[label]`` [B, S]. Over
    DTensor logits sharded by vocab over "model", the max, the sum of
    exps and the gold logit reduce over "model" as partial results, and
    the logits are never gathered."""
    if not spmd.is_dtensor(logits):
        return (torch.logsumexp(logits, dim=-1)
                - logits.gather(-1, labels.long()[..., None])[..., 0])
    with spmd.replicate_plain(logits):
        return (_VocabLogZ.apply(logits)
                - spmd.reduce_partial(_gold_logit(logits, labels)))


class _VocabLogZ(torch.autograd.Function):
    """``logsumexp`` over the last, vocab-sharded dim of DTensor logits:
    the max and the sum of exps reduce over "model". The forward takes
    ``torch.logsumexp``'s steps and the backward is its formula,
    ``g · exp(x - logz)``, so on one rank both equal the single-device
    ones bit for bit (an equivalent form, ``exp(x - m) / z``, rounds
    apart in the last bits, which the chunked attention's bfloat16
    probabilities raise to ~1e-4 of a gradient's max)."""

    @staticmethod
    def forward(ctx, logits):
        m = spmd.reduce_partial(logits.amax(-1, keepdim=True))
        z = spmd.reduce_partial(torch.exp(logits - m).sum(-1, keepdim=True))
        logz = z.log() + m
        ctx.save_for_backward(logits, logz)
        return logz[..., 0]

    @staticmethod
    def backward(ctx, g):
        logits, logz = ctx.saved_tensors
        return g[..., None] * torch.exp(logits - logz)


def _gold_logit(logits, labels):
    """Each position's logit at its label, over vocab-sharded DTensor
    logits [B, S, V]: each rank takes the labels in its vocab slice (a
    partial sum over "model"; DTensor's own ``gather`` would rebuild the
    full vocab in the backward)."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    mesh = logits.device_mesh
    lo = _vocab_lo(mesh, logits.shape[-1])

    def gold(lg, lb):
        idx = lb.long() - lo
        inside = (idx >= 0) & (idx < lg.shape[-1])
        g = lg.gather(-1, idx.clamp(0, lg.shape[-1] - 1)[..., None])[..., 0]
        return torch.where(inside, g, 0.0)

    names = mesh.mesh_dim_names
    batch = tuple(p if isinstance(p, Shard) and p.dim == 0 else Replicate()
                  for p in logits.placements)
    vocab = tuple(Shard(2) if a == "model" else p
                  for a, p in zip(names, batch))
    out = tuple(Partial() if a == "model" else p
                for a, p in zip(names, batch))
    return spmd.local(gold, out, (vocab, batch), mesh, logits,
                      spmd.as_dtensor(labels, mesh))
