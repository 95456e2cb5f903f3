"""Sharding rules per model family, the port of ``repro.sharding.rules``,
and their placement on a ``torch.distributed`` ``DeviceMesh`` as DTensors.

A spec is a tuple with one entry per tensor dim, the counterpart of a
``PartitionSpec``: a mesh axis name, a tuple of names, or None. ``()``
is replicated. The strategy is the reference's, on a 2-D mesh
``("data", "model")`` of 16 × 16 ranks with an optional leading
``"pod"`` axis:

- dense LM: Megatron tensor parallelism over "model" (attention heads,
  FFN hidden, vocabulary) with FSDP-style weight sharding over "data" on
  the other matrix dim. The batch shards over ``("pod", "data")``; the
  pod axis is pure data parallelism for the parameters.
- MoE LM: experts over "model" (expert parallelism), the expert matrices
  also over "data" on d_model; the dense residual as a dense LM's.
- GNN: node- and edge-leading arrays over the widest axes that divide
  them; parameters replicated.
- DIN: embedding tables row-sharded over ``("data", "model")``; MLPs
  replicated; the batch over ``("pod", "data")``.

Optimizer moments take their parameter's spec.

The LM rules work on the port's own names and layouts: one module per
layer (``layers.{i}.…``, no stacked leading ``L``) and projections kept
as ``[out, in]`` ``.weight``s, the transpose of the reference's ``[in,
out]`` (``convert.lm_state_from_reference``). So the reference's ``wq``
``[L, d, q]`` under ``(None, "data", "model")`` is ``layers.{i}.wq.
weight`` ``[q, d]`` under ``("model", "data")``; the experts' stacks keep
the reference's layout and drop only ``L``.

A mesh here is anything with ``mesh_dim_names`` and ``shape`` (a
``DeviceMesh``); the rules read nothing else. :func:`to_placements`
turns a spec into DTensor placements: a tensor dim over ``("data",
"model")`` is ``Shard(dim)`` on both mesh dims, so rank ``r``'s block is
the one JAX's ``NamedSharding`` gives device ``r`` (row-major over the
named axes, which must follow the mesh's order).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Sequence

Spec = tuple

__all__ = ["batch_axes", "lm_param_specs", "lm_batch_specs",
           "lm_cache_specs", "best_dim0_axes", "gnn_batch_specs",
           "din_param_specs", "best_dim0_axes_static", "din_batch_specs",
           "opt_state_specs", "tree_shardings", "axis_sizes",
           "to_placements", "local_shape", "is_spec", "map_specs"]


def axis_sizes(mesh) -> Dict[str, int]:
    """``{axis name: size}`` of a ``DeviceMesh`` (or any object with
    ``mesh_dim_names`` and ``shape``)."""
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))


def batch_axes(mesh) -> tuple:
    """Mesh axes the batch dimension shards over."""
    return ("pod", "data") if "pod" in mesh.mesh_dim_names else ("data",)


def is_spec(x) -> bool:
    """A spec leaf: a plain tuple (a named tuple is a tree node)."""
    return isinstance(x, tuple) and not hasattr(x, "_fields")


def map_specs(fn, tree):
    """``fn`` over every spec leaf (and None) of a tree of dicts and named
    tuples."""
    if tree is None or is_spec(tree):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: map_specs(fn, v) for k, v in tree.items()}
    return type(tree)(*(map_specs(fn, v) for v in tree))


# ---------------------------------------------------------------------------
# LM transformers
# ---------------------------------------------------------------------------

def _lm_rule(name: str, nd: int) -> Spec:
    """The spec of one port parameter, in the reference's order of name
    tests (``moe`` before the plain FFN names)."""
    if "embed" in name:                       # [V, d]
        return ("model", "data")
    if "lm_head" in name:                     # [V, d] (reference [d, V])
        return ("model", "data")
    if "moe" in name:
        if "router" in name:                  # [E, d]
            return (None, "data")
        if "dense_gate" in name or "dense_up" in name:   # [ff, d]
            return ("model", "data")
        if "dense_down" in name:              # [d, ff]
            return ("data", "model")
        # expert FFN: E over "model" (expert parallelism), d_model over
        # "data"
        if "w_down" in name:                  # [E, ff, d]
            return ("model", None, "data")
        if nd == 3:                           # w_gate / w_up [E, d, ff]
            return ("model", "data", None)
    if "wq" in name or "wk" in name or "wv" in name:     # [q, d]
        return ("model", "data")
    if "wo" in name:                          # [d, q]
        return ("data", "model")
    if "w_gate" in name or "w_up" in name:    # [ff, d]
        return ("model", "data")
    if "w_down" in name:                      # [d, ff]
        return ("data", "model")
    return ()                                 # norms: replicated


def lm_param_specs(cfg, params: Dict[str, Any]) -> Dict[str, Spec]:
    """Spec of each of the transformer's named parameters (anything with
    a ``shape``: tensors on any device, meta included)."""
    return {k: _lm_rule(k, len(v.shape)) for k, v in params.items()}


def lm_batch_specs(mesh):
    ba = batch_axes(mesh)
    return ((ba, None), (ba, None))           # (tokens, labels)


def lm_cache_specs(mesh, cfg) -> Spec:
    """KV cache ``[L, B, T, KV, hd]``: batch over the data axes, the
    sequence over "model" (GQA's 4-16 kv heads do not divide a 16-wide
    axis; the reference's split-KV decode)."""
    return (None, batch_axes(mesh), "model", None, None)


# ---------------------------------------------------------------------------
# GNN
# ---------------------------------------------------------------------------

def best_dim0_axes(mesh, n: int) -> Optional[tuple]:
    """Widest mesh-axis combination that divides dim 0 evenly."""
    sizes = axis_sizes(mesh)
    candidates = [("pod", "data", "model"), ("data", "model"),
                  ("pod", "data"), ("data",), ("model",)]
    for axes in candidates:
        if not all(a in sizes for a in axes):
            continue
        if n % math.prod(sizes[a] for a in axes) == 0:
            return axes
    return None


def gnn_batch_specs(mesh, batch_shape) -> Any:
    """Node- and edge-leading arrays over the widest dividing axes; small
    or odd ones replicated. ``batch_shape`` is a named tuple (or dict)
    whose leaves have a ``shape`` or are None; other fields (counts,
    flags) map to None."""

    def rule(leaf):
        if leaf is None or not hasattr(leaf, "shape"):
            return None
        nd = len(leaf.shape)
        if nd == 0:
            return ()
        axes = best_dim0_axes(mesh, leaf.shape[0])
        if axes is None:
            return ()
        return (axes, *([None] * (nd - 1)))

    return _map_leaves(rule, batch_shape)


def _map_leaves(fn, tree):
    """``fn`` over the leaves of dicts, named tuples and dataclasses (a
    dataclass's fields that hold no tensor, counts and sizes, stay)."""
    if isinstance(tree, dict):
        return {k: _map_leaves(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map_leaves(fn, v) for v in tree))
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: _map_leaves(fn, getattr(tree, f.name))
            for f in dataclasses.fields(tree)
            if hasattr(getattr(tree, f.name), "shape")})
    return fn(tree)


# ---------------------------------------------------------------------------
# DIN
# ---------------------------------------------------------------------------

def din_param_specs(cfg, params: Dict[str, Any]) -> Dict[str, Spec]:
    def rule(name, leaf):
        if "table" in name:                   # [rows, d] row-sharded
            axes = best_dim0_axes_static(leaf.shape[0])
            return (axes, None) if axes else ()
        return ()

    return {k: rule(k, v) for k, v in params.items()}


def best_dim0_axes_static(n: int) -> Optional[tuple]:
    """Mesh-independent variant for tables on a 16-wide model axis."""
    for axes, prod in ((("data", "model"), 256), (("model",), 16)):
        if n % prod == 0:
            return axes
    return None


def din_batch_specs(mesh, batch_shape) -> Any:
    ba = batch_axes(mesh)

    def rule(leaf):
        nd = len(leaf.shape)
        return () if nd == 0 else (ba, *([None] * (nd - 1)))

    return _map_leaves(rule, batch_shape)


# ---------------------------------------------------------------------------
# generic helpers
# ---------------------------------------------------------------------------

def opt_state_specs(param_specs: Dict[str, Spec], opt_state) -> Any:
    """Moments take the parameter's spec; the step is replicated."""
    from repro_torch.training.optimizer import OptState
    v = dict(param_specs) if opt_state.v is not None else None
    return OptState(step=(), m=dict(param_specs), v=v)


def _entry_axes(entry) -> tuple:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def to_placements(mesh, spec: Spec) -> tuple:
    """DTensor placements (one per mesh dim) of ``spec``. A sequence of
    placements is returned as it is."""
    from torch.distributed.tensor import Placement, Replicate, Shard
    if len(spec) and all(isinstance(p, Placement) for p in spec):
        return tuple(spec)
    names = list(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for dim, entry in enumerate(spec):
        axes = _entry_axes(entry)
        pos = [names.index(a) for a in axes]
        if pos != sorted(pos):
            raise ValueError(f"spec entry {entry!r} does not follow the "
                             f"mesh's axis order {tuple(names)}")
        for i in pos:
            out[i] = Shard(dim)
    return tuple(out)


def local_shape(shape: Sequence[int], mesh, spec: Spec) -> tuple:
    """Rank 0's block of a ``shape`` tensor under ``spec``: each sharded
    dim cut into ``ceil(n / ranks)`` (the largest block, as a padded JAX
    shard)."""
    sizes = axis_sizes(mesh)
    out = list(shape)
    for dim, entry in enumerate(spec):
        k = math.prod(sizes[a] for a in _entry_axes(entry))
        out[dim] = -(-out[dim] // k)
    return tuple(out)


def tree_shardings(mesh, spec_tree) -> Any:
    """Each spec of the tree as ``(mesh, placements)`` (None stays None),
    what ``training.checkpoint.restore`` takes as ``shardings``."""
    return map_specs(lambda s: None if s is None
                     else (mesh, to_placements(mesh, s)), spec_tree)
