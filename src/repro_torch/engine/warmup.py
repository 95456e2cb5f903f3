"""Warmup-file persistence: the serialisable identity of hot plans.

What survives a server restart is the **key set** of the plan cache, not
the plans themselves: a recipe records everything needed to re-derive a
:class:`~repro_torch.engine.planner.PlanKey` — graph fingerprint, query
kind, params, padded batch width, backend, and layout flags — as a few
dozen bytes of JSON. ``GraphQueryServer.warmup`` replays each recipe as
one dummy launch, which rebuilds the exact plan (and pays the work-item
cuts and kernel builds) that the first real query would otherwise stall
on. The plans close over device tensors, so they are not persisted;
recipes are stable across restarts, upgrades and hardware moves.

The format is the reference's, version 1, so a file written by either
package loads in the other; ``sharded`` is the served graph's flag, and a
recipe replays only on a graph whose flag matches:

    {"version": 1,
     "recipes": [{"graph_fp": "...", "kind": "bfs",
                  "params": {"max_iters": null}, "width": 32,
                  "backend": "b2sr_cuda", "use_buckets": true,
                  "sharded": false}, ...]}
"""

from __future__ import annotations

import json
import os
from typing import Iterable, List

VERSION = 1

_REQUIRED = ("graph_fp", "kind", "params", "width", "backend",
             "use_buckets", "sharded")


def recipe_key(recipe: dict) -> tuple:
    """Dedup identity of one recipe (its PlanKey coordinates)."""
    return (recipe["graph_fp"], recipe["kind"],
            tuple(sorted(recipe["params"].items())), recipe["width"],
            recipe["backend"], recipe["use_buckets"], recipe["sharded"])


def _validate(recipe: dict, where: str) -> dict:
    for field in _REQUIRED:
        if field not in recipe:
            raise ValueError(f"{where}: recipe missing field {field!r}: "
                             f"{recipe!r}")
    if not isinstance(recipe["params"], dict):
        raise ValueError(f"{where}: recipe params must be a dict, got "
                         f"{type(recipe['params']).__name__}")
    if not (isinstance(recipe["width"], int) and recipe["width"] >= 1):
        raise ValueError(f"{where}: recipe width must be an int >= 1, got "
                         f"{recipe['width']!r}")
    return recipe


def save(path: str, recipes: Iterable[dict]) -> int:
    """Write the recipe set to ``path`` (atomically); returns the count."""
    payload = {"version": VERSION,
               "recipes": [_validate(dict(r), path) for r in recipes]}
    tmp = f"{path}.tmp"
    with open(tmp, "w") as f:
        json.dump(payload, f, indent=1, sort_keys=True)
    os.replace(tmp, path)
    return len(payload["recipes"])


def load(path: str) -> List[dict]:
    """Read and validate a warmup file (FileNotFoundError if absent,
    ValueError on a malformed or version-incompatible file)."""
    with open(path) as f:
        try:
            payload = json.load(f)
        except json.JSONDecodeError as e:
            raise ValueError(f"{path}: not a warmup file: {e}") from e
    if not isinstance(payload, dict) or payload.get("version") != VERSION:
        raise ValueError(
            f"{path}: unsupported warmup file version "
            f"{payload.get('version') if isinstance(payload, dict) else '?'}"
            f" (expected {VERSION})")
    return [_validate(r, path) for r in payload.get("recipes", [])]
