"""gemma-7b [arXiv:2403.08295; hf]: dense 28L GeGLU, head_dim=256."""

from __future__ import annotations

import dataclasses

from repro_torch.configs.lm import TransformerConfig

CONFIG = TransformerConfig(
    name="gemma-7b",
    n_layers=28,
    d_model=3072,
    n_heads=16,
    n_kv_heads=16,
    head_dim=256,
    d_ff=24576,
    vocab_size=256000,
    activation="geglu",
    tie_embeddings=True,
)


def reduced() -> TransformerConfig:
    """The same model at a test size (the reference's ``reduced``)."""
    return dataclasses.replace(
        CONFIG, name="gemma-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=4, head_dim=16, d_ff=256, vocab_size=256,
        dtype="float32", max_seq_len=64)
