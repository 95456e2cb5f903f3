"""phi4-mini-3.8b [arXiv:2412.08905; hf]: dense 32L RoPE SwiGLU GQA."""

from __future__ import annotations

import dataclasses

from repro_torch.configs.lm import TransformerConfig

CONFIG = TransformerConfig(
    name="phi4-mini-3.8b",
    n_layers=32,
    d_model=3072,
    n_heads=24,
    n_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=200064,
    activation="swiglu",
    tie_embeddings=True,
)


def reduced() -> TransformerConfig:
    """The same model at a test size (the reference's ``reduced``)."""
    return dataclasses.replace(
        CONFIG, name="phi4-mini-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, head_dim=16, d_ff=128, vocab_size=256,
        dtype="float32", max_seq_len=64)
