"""The LM configurations, the port of ``repro.configs.base``'s
``MoEConfig`` and ``TransformerConfig`` (the same fields, in the same
order, with the same defaults, so ``dataclasses.asdict`` of a port config
equals the reference's).

``dtype`` is the compute dtype: parameters stay float32 and each weight
is cast to the activations' dtype where it is used. The GSPMD fields act
as in the reference once the model runs over DTensors on a mesh
(``repro_torch.sharding``): ``batch_axes`` pins the residual stream's
batch to those mesh axes (and, with ``seq_parallel_residual`` and heads
that ``tp_width`` does not divide, its sequence to "model");
``attn_seq_shard`` shards the chunked attention's q blocks over "model";
``moe_shardmap_dispatch`` takes the MoE's expert-parallel dispatch. On
plain tensors they do nothing. ``scan_layers`` changes how the
reference compiles its layers, not what they compute: the port keeps
one module per layer.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    capacity_factor: float = 1.25
    dense_residual_d_ff: Optional[int] = None  # Arctic: parallel dense FFN
    router_z_loss: float = 1e-3
    load_balance_loss: float = 1e-2


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    activation: str = "swiglu"          # swiglu | geglu | relu2
    rope_theta: float = 10000.0
    norm_eps: float = 1e-6
    qk_norm: bool = False
    tie_embeddings: bool = False
    moe: Optional[MoEConfig] = None
    dtype: str = "bfloat16"             # compute dtype
    remat: bool = True                  # one checkpoint per layer
    scan_layers: bool = True            # unused: one module per layer
    max_seq_len: int = 32768
    batch_axes: tuple = ()              # mesh axes of the batch
    attn_seq_shard: bool = True
    tp_width: int = 0                   # size of the "model" axis
    moe_shardmap_dispatch: bool = True  # expert-parallel MoE on a mesh
    # the chunked attention's exp in bfloat16 (m and l stay float32)
    attn_probs_bf16: bool = True
    seq_parallel_residual: bool = True

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    def _attn(self) -> int:
        d = self.d_model
        return d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d

    def _embed(self) -> int:
        return self.vocab_size * self.d_model * (
            1 if self.tie_embeddings else 2)

    def n_params(self) -> int:
        """Total parameter count (for 6ND model-FLOPs accounting; the
        norm scales are not counted, as in the reference)."""
        d = self.d_model
        if self.moe is None:
            ffn = (3 if self.activation in ("swiglu", "geglu") else 2
                   ) * d * self.d_ff
        else:
            ffn = (self.moe.n_experts * 3 * d * self.moe.d_ff_expert
                   + d * self.moe.n_experts)
            if self.moe.dense_residual_d_ff:
                ffn += 3 * d * self.moe.dense_residual_d_ff
        return self.n_layers * (self._attn() + ffn) + self._embed()

    def n_active_params(self) -> int:
        """Active parameters per token (MoE: only routed experts count)."""
        if self.moe is None:
            return self.n_params()
        d = self.d_model
        ffn = (self.moe.top_k * 3 * d * self.moe.d_ff_expert
               + d * self.moe.n_experts)
        if self.moe.dense_residual_d_ff:
            ffn += 3 * d * self.moe.dense_residual_d_ff
        return self.n_layers * (self._attn() + ffn) + self._embed()
