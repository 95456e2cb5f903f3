"""Model configurations the port runs (its own copies: no import of the
reference's ``repro.configs``) and the architecture registry: ``--arch
<id>`` → config and shape ids, over the four GNN families.

The reference's LM and DIN ids are known here but not ported: asking
for one raises ``NotImplementedError`` (ROADMAP Queue 1 item 10).
"""

from __future__ import annotations

import importlib
from typing import Dict

from repro_torch.configs.gnn import GNNConfig  # noqa: F401

_MODULES: Dict[str, str] = {
    "egnn": "repro_torch.configs.egnn",
    "gcn-cora": "repro_torch.configs.gcn_cora",
    "gatedgcn": "repro_torch.configs.gatedgcn",
    "graphcast": "repro_torch.configs.graphcast",
}

#: the reference's ids whose families the port has not yet
_NOT_PORTED = ("phi4-mini-3.8b", "gemma-7b", "minitron-4b",
               "qwen3-moe-30b-a3b", "arctic-480b", "din")

ARCH_IDS = tuple(_MODULES)

# shape ids of the GNN families (the reference's assignment table)
GNN_SHAPES = ("full_graph_sm", "minibatch_lg", "ogb_products", "molecule")


def _module(arch_id: str):
    if arch_id in _NOT_PORTED:
        raise NotImplementedError(
            f"arch {arch_id!r} is not ported yet (ROADMAP Queue 1 item 10); "
            f"ported: {ARCH_IDS}")
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; available: {ARCH_IDS}")
    return importlib.import_module(_MODULES[arch_id])


def get_config(arch_id: str) -> GNNConfig:
    return _module(arch_id).CONFIG


def get_reduced_config(arch_id: str) -> GNNConfig:
    return _module(arch_id).reduced()


def shapes_for(arch_id: str) -> tuple:
    _module(arch_id)
    return GNN_SHAPES
