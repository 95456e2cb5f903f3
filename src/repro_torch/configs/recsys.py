"""The recommender configuration, the port of
``repro.configs.base.DINConfig`` (the same fields, in the same order,
with the same defaults, so ``dataclasses.asdict`` of a port config equals
the reference's)."""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class DINConfig:
    name: str
    embed_dim: int = 18
    seq_len: int = 100
    attn_mlp: Tuple[int, ...] = (80, 40)
    mlp: Tuple[int, ...] = (200, 80)
    n_items: int = 1_000_000
    n_cates: int = 10_000
    n_user_feats: int = 8               # extra categorical fields
    user_feat_vocab: int = 100_000
    dtype: str = "float32"
