"""DTensor helpers of the SPMD path: place tensors by spec, pin a
layout (the counterpart of ``with_sharding_constraint``), gather a
DTensor back to a full tensor, and let plain tensors built inside a
sharded computation act as replicated.

Everything is a no-op on plain tensors, so the single-device path runs
exactly as it would without this module. ``torch.distributed.tensor`` is
imported on first use, never when this module is.
"""

from __future__ import annotations

import contextlib
import sys
from typing import Any, Tuple

import torch
import torch.nn.functional as F

from repro_torch.sharding.rules import Spec, to_placements


def is_dtensor(x: Any) -> bool:
    # no DTensor exists before its module is loaded: the single-device
    # path never imports it
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(x, mod.DTensor)


def model_rank(mesh) -> Tuple[int, int]:
    """``(coordinate, size)`` of this rank on "model" (0 and 1 without
    one)."""
    if "model" not in mesh.mesh_dim_names:
        return 0, 1
    return (mesh.get_local_rank("model"),
            dict(zip(mesh.mesh_dim_names, mesh.shape))["model"])


def local(fn, out_placements, in_placements, mesh, *args,
          in_grad_placements=None):
    """``fn`` over each rank's local tensors of ``args`` (redistributed
    to ``in_placements`` first), one output placed by ``out_placements``
    (``local_map`` with the output in a tuple, as every version takes
    it). ``in_grad_placements`` (default ``in_placements``) says how the
    ranks' local gradients of each input combine: an input replicated
    over an axis whose ranks compute different things has a partial
    gradient there."""
    from torch.distributed.tensor.experimental import local_map
    return local_map(lambda *xs: (fn(*xs),), out_placements=(out_placements,),
                     in_placements=in_placements,
                     in_grad_placements=in_grad_placements, device_mesh=mesh,
                     redistribute_inputs=True)(*args)[0]


def place(t: torch.Tensor, mesh, spec: Spec):
    """``t`` (the full tensor, on every rank) as a DTensor on ``mesh``
    under ``spec`` (or a sequence of placements)."""
    from torch.distributed.tensor import distribute_tensor
    return distribute_tensor(t, mesh, to_placements(mesh, spec))


def place_tree(tree: Any, mesh, spec_tree: Any) -> Any:
    """Every tensor of a tree of dicts, tuples and named tuples placed by
    the spec at the same position (None leaves stay None)."""
    if tree is None:
        return None
    if isinstance(tree, torch.Tensor):
        return place(tree, mesh, spec_tree)
    if isinstance(tree, dict):
        return {k: place_tree(v, mesh, spec_tree[k]) for k, v in tree.items()}
    items = [place_tree(v, mesh, s) for v, s in zip(tree, spec_tree)]
    return type(tree)(*items) if hasattr(tree, "_fields") \
        else type(tree)(items)


def as_dtensor(x: torch.Tensor, mesh):
    """``x`` as a DTensor on ``mesh``: a plain tensor is taken as
    replicated (every rank holds the whole of it)."""
    if is_dtensor(x):
        return x
    from torch.distributed.tensor import DTensor, Replicate
    return DTensor.from_local(x, mesh, (Replicate(),) * mesh.ndim,
                              run_check=False)


def constrain(x: torch.Tensor, spec: Spec) -> torch.Tensor:
    """A DTensor redistributed to ``spec`` on its own mesh; a plain tensor
    as it is."""
    if not is_dtensor(x):
        return x
    mesh = x.device_mesh
    return x.redistribute(mesh, to_placements(mesh, spec))


def gather_data(w: torch.Tensor) -> torch.Tensor:
    """A DTensor weight all-gathered over every mesh axis but "model"
    (FSDP: stored sharded over the data axes, gathered where it is used,
    so the activations keep their batch sharding); a plain tensor as it
    is."""
    if not is_dtensor(w):
        return w
    from torch.distributed.tensor import Replicate
    mesh = w.device_mesh
    pl = tuple(p if name == "model" else Replicate()
               for name, p in zip(mesh.mesh_dim_names, w.placements))
    return w if pl == tuple(w.placements) else w.redistribute(mesh, pl)


def linear(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``F.linear(x, w)``. A DTensor weight ``[out, in]`` is gathered over
    the data axes first (:func:`gather_data`), each rank multiplying its
    local blocks (``local_map``), so no matmul meets DTensor's sharding
    propagation (whose strategy search over a 3-D mesh costs seconds an
    op). On "model", Megatron's split: a weight sharded by rows (column
    parallel) takes x replicated there and gives its output sharded on
    the last dim; by columns (row parallel) takes x sharded on its last
    dim and gives a partial sum; a replicated one keeps x's layout. x
    keeps its placements on the other axes (the batch over the data
    axes); a rank's gradient of an input replicated over an axis where
    the ranks hold different data is a partial sum there."""
    if not is_dtensor(w):
        return F.linear(x, w)
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    w = gather_data(w)
    mesh = w.device_mesh
    x = reduce_partial(as_dtensor(x, mesh))
    last = x.dim() - 1
    x_pl, out_pl, xg_pl, wg_pl = [], [], [], []
    for name, xp, wp in zip(mesh.mesh_dim_names, x.placements,
                            w.placements):
        if name == "model" and wp == Shard(0):        # column parallel
            xp, op, xg = Replicate(), Shard(last), Partial()
        elif name == "model" and wp == Shard(1):      # row parallel
            xp, op, xg = Shard(last), Partial(), Shard(last)
        else:
            op = xg = xp
        x_pl.append(xp)
        out_pl.append(op)
        xg_pl.append(xg)
        wg_pl.append(wp if isinstance(wp, Shard) else
                     Partial() if isinstance(xp, Shard) else Replicate())
    return local_map(lambda a, b: (F.linear(a, b),),
                     out_placements=(tuple(out_pl),),
                     in_placements=(tuple(x_pl), tuple(w.placements)),
                     in_grad_placements=(tuple(xg_pl), tuple(wg_pl)),
                     device_mesh=mesh, redistribute_inputs=True)(x, w)[0]


def reduce_partial(x: torch.Tensor) -> torch.Tensor:
    """A DTensor's partial placements (a sum, max or masked sum over a
    mesh axis) reduced to replicated; the others kept."""
    from torch.distributed.tensor import Replicate
    pl = tuple(Replicate() if p.is_partial() else p for p in x.placements)
    return x.redistribute(x.device_mesh, pl)


def full(x: Any) -> Any:
    """A DTensor's full value as a plain tensor on its rank's device (a
    gather over the mesh); any other value as it is."""
    return x.full_tensor() if is_dtensor(x) else x


def full_tree(tree: Any) -> Any:
    """:func:`full` of every leaf of a tree of dicts and named tuples."""
    if isinstance(tree, dict):
        return {k: full_tree(v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(full_tree(v) for v in tree))
    return full(tree)


def replicate_plain(*xs):
    """A context in which plain tensors mixed with DTensors act as
    replicated, entered only when one of ``xs`` (tensors, or dicts of
    them) is a DTensor: the model's own constants (RoPE tables, masks,
    positions, zero accumulators) then meet sharded activations;
    otherwise a null context."""
    for x in xs:
        vals = x.values() if isinstance(x, dict) else (x,)
        if any(is_dtensor(v) for v in vals):
            return _implicit_replication()
    return contextlib.nullcontext()


@contextlib.contextmanager
def _implicit_replication():
    # ``implicit_replication()`` sets the dispatcher's flag and clears it
    # on exit, so a nested use (the forward inside ``value_and_grad``,
    # whose backward needs the flag too) would end the outer one: this
    # restores the value it found
    from torch.distributed.tensor import DTensor
    disp = DTensor._op_dispatcher
    prev = disp._allow_implicit_replication
    disp._allow_implicit_replication = True
    try:
        yield
    finally:
        disp._allow_implicit_replication = prev
