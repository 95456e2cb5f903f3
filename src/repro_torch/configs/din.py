"""din [arXiv:1706.06978]: target attention over the user's behaviour
sequence."""

from __future__ import annotations

import dataclasses

from repro_torch.configs.recsys import DINConfig

CONFIG = DINConfig(
    name="din",
    embed_dim=18,
    seq_len=100,
    attn_mlp=(80, 40),
    mlp=(200, 80),
    n_items=1_000_000,
    n_cates=10_000,
)


def reduced() -> DINConfig:
    """The same model at a test size (the reference's ``reduced``)."""
    return dataclasses.replace(
        CONFIG, name="din-smoke", embed_dim=8, seq_len=10, attn_mlp=(16, 8),
        mlp=(32, 16), n_items=1000, n_cates=100, n_user_feats=2,
        user_feat_vocab=100)
