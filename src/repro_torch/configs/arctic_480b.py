"""arctic-480b [hf:Snowflake/snowflake-arctic-base]: 128e top-2 + dense residual."""

from __future__ import annotations

import dataclasses

from repro_torch.configs.lm import MoEConfig, TransformerConfig

CONFIG = TransformerConfig(
    name="arctic-480b",
    n_layers=35,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    head_dim=128,
    d_ff=4864,  # per-expert
    vocab_size=32000,
    activation="swiglu",
    moe=MoEConfig(n_experts=128, top_k=2, d_ff_expert=4864,
                  dense_residual_d_ff=4864),
)


def reduced() -> TransformerConfig:
    """The same model at a test size (the reference's ``reduced``)."""
    return dataclasses.replace(
        CONFIG, name="arctic-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, head_dim=16, d_ff=48, vocab_size=256, dtype="float32",
        moe=MoEConfig(n_experts=8, top_k=2, d_ff_expert=48,
                      dense_residual_d_ff=48), max_seq_len=64)
