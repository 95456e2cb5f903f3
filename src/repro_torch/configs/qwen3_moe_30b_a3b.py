"""qwen3-moe-30b-a3b [hf:Qwen/Qwen3-30B-A3B]: 128 experts, top-8, QK-norm."""

from __future__ import annotations

import dataclasses

from repro_torch.configs.lm import MoEConfig, TransformerConfig

CONFIG = TransformerConfig(
    name="qwen3-moe-30b-a3b",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=4,
    head_dim=128,
    d_ff=768,  # per-expert
    vocab_size=151936,
    activation="swiglu",
    qk_norm=True,
    moe=MoEConfig(n_experts=128, top_k=8, d_ff_expert=768),
)


def reduced() -> TransformerConfig:
    """The same model at a test size (the reference's ``reduced``)."""
    return dataclasses.replace(
        CONFIG, name="qwen3-moe-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, head_dim=16, d_ff=32, vocab_size=256, dtype="float32",
        moe=MoEConfig(n_experts=8, top_k=2, d_ff_expert=32), max_seq_len=64)
