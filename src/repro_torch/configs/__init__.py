"""Model configurations the port runs (its own copies: no import of the
reference's ``repro.configs``) and the architecture registry: ``--arch
<id>`` → config and shape ids, over the reference's ten ids: the five LM
configs, the four GNN families and DIN.
"""

from __future__ import annotations

import importlib
from typing import Dict, Union

from repro_torch.configs.gnn import GNNConfig  # noqa: F401
from repro_torch.configs.lm import MoEConfig, TransformerConfig  # noqa: F401
from repro_torch.configs.recsys import DINConfig  # noqa: F401

ArchConfig = Union[TransformerConfig, GNNConfig, DINConfig]

_MODULES: Dict[str, str] = {
    "phi4-mini-3.8b": "repro_torch.configs.phi4_mini_3_8b",
    "gemma-7b": "repro_torch.configs.gemma_7b",
    "minitron-4b": "repro_torch.configs.minitron_4b",
    "qwen3-moe-30b-a3b": "repro_torch.configs.qwen3_moe_30b_a3b",
    "arctic-480b": "repro_torch.configs.arctic_480b",
    "egnn": "repro_torch.configs.egnn",
    "gcn-cora": "repro_torch.configs.gcn_cora",
    "gatedgcn": "repro_torch.configs.gatedgcn",
    "graphcast": "repro_torch.configs.graphcast",
    "din": "repro_torch.configs.din",
}

ARCH_IDS = tuple(_MODULES)

# shape ids per family (the reference's assignment table)
LM_SHAPES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")
GNN_SHAPES = ("full_graph_sm", "minibatch_lg", "ogb_products", "molecule")
DIN_SHAPES = ("train_batch", "serve_p99", "serve_bulk", "retrieval_cand")

# long_500k skipped for the pure full-attention LM archs
SKIPPED_CELLS = tuple(
    (a, "long_500k")
    for a in ("phi4-mini-3.8b", "gemma-7b", "minitron-4b",
              "qwen3-moe-30b-a3b", "arctic-480b"))


def _module(arch_id: str):
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; available: {ARCH_IDS}")
    return importlib.import_module(_MODULES[arch_id])


def get_config(arch_id: str) -> ArchConfig:
    return _module(arch_id).CONFIG


def get_reduced_config(arch_id: str) -> ArchConfig:
    return _module(arch_id).reduced()


def shapes_for(arch_id: str) -> tuple:
    cfg = get_config(arch_id)
    if isinstance(cfg, TransformerConfig):
        return LM_SHAPES
    if isinstance(cfg, GNNConfig):
        return GNN_SHAPES
    return DIN_SHAPES


def all_cells(include_skipped: bool = False):
    """Every (arch, shape) pair of the assignment; skips applied by
    default."""
    for arch in ARCH_IDS:
        for shape in shapes_for(arch):
            if not include_skipped and (arch, shape) in SKIPPED_CELLS:
                continue
            yield arch, shape
