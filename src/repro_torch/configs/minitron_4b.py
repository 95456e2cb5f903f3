"""minitron-4b [arXiv:2407.14679; hf]: pruned Nemotron, squared-ReLU FFN."""

from __future__ import annotations

import dataclasses

from repro_torch.configs.lm import TransformerConfig

CONFIG = TransformerConfig(
    name="minitron-4b",
    n_layers=32,
    d_model=3072,
    n_heads=24,
    n_kv_heads=8,
    head_dim=128,
    d_ff=9216,
    vocab_size=256000,
    activation="relu2",
)


def reduced() -> TransformerConfig:
    """The same model at a test size (the reference's ``reduced``)."""
    return dataclasses.replace(
        CONFIG, name="minitron-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, head_dim=16, d_ff=160, vocab_size=256,
        dtype="float32", max_seq_len=64)
