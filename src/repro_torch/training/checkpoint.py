"""Step-atomic checkpoints of a tree of tensors.

Layout: ``<dir>/step_<N>/shard_0.ckpt`` and ``manifest.json``, as the
reference's ``repro.training.checkpoint``. A step is written into
``step_<N>.tmp``, its manifest last, and then renamed, so a crash in the
middle never shows: ``latest_step`` trusts only directories with a
manifest. One host writes one shard. Checkpoints are mesh-agnostic, as
the reference's: ``save`` gathers each DTensor to its full value (a
collective every rank of its mesh joins) and rank 0 writes, and
``restore`` places each array on whatever mesh ``shardings`` names
(``distribute_tensor``), which need not be the mesh it was saved from.

A tree is nested dicts and named tuples (``OptState``) of tensors; None
leaves are skipped. A leaf's key is its path joined with ``/``, the
names of the state dict and of the optimizer state (``params/layers.0.
weight``, ``opt/m/layers.0.weight``, ``opt/step``). The shard is a JSON
header (each array's key, dtype, shape, offset and length) and the
arrays' raw bytes, compressed with the standard library's ``zlib``, so
it needs no package beyond PyTorch and holds bfloat16 as it is.
"""

from __future__ import annotations

import json
import os
import shutil
import struct
import zlib
from typing import Any, Dict, Iterator, List, Optional, Tuple

import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.sharding import spmd

_HEADER_LEN = struct.Struct("<Q")


def _items(tree: Any, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    """(key, leaf) of every tensor of ``tree`` in a fixed order."""
    if tree is None:
        return
    if isinstance(tree, torch.Tensor):
        yield prefix, tree
        return
    if isinstance(tree, dict):
        pairs = tree.items()
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        pairs = zip(tree._fields, tree)
    else:
        raise TypeError(f"cannot checkpoint a {type(tree).__name__} at "
                        f"{prefix or 'the root'}")
    for name, sub in pairs:
        yield from _items(sub, f"{prefix}/{name}" if prefix else str(name))


def _rebuild(like: Any, arrays: Dict[str, torch.Tensor],
             shardings: Any = None, prefix: str = "") -> Any:
    """``like``'s structure over ``arrays``; a leaf whose ``shardings``
    entry is ``(mesh, spec or placements)`` is placed there."""
    if like is None:
        return None
    if isinstance(like, torch.Tensor):
        if shardings is None:
            return arrays[prefix]
        return spmd.place(arrays[prefix], *shardings)

    def key(name):
        return f"{prefix}/{name}" if prefix else str(name)

    if isinstance(like, dict):
        return {k: _rebuild(v, arrays, None if shardings is None
                            else shardings[k], key(k))
                for k, v in like.items()}
    subs = [None] * len(like) if shardings is None else list(shardings)
    return type(like)(*(_rebuild(v, arrays, sh, key(f))
                        for f, v, sh in zip(like._fields, like, subs)))


def _encode(tree: Any) -> Tuple[bytes, int]:
    header: List[dict] = []
    blobs: List[bytes] = []
    offset = 0
    for key, t in _items(tree):
        raw = spmd.full(t.detach()).cpu().contiguous().reshape(-1).view(
            torch.uint8).numpy().tobytes()
        header.append({"key": key, "dtype": str(t.dtype).split(".")[-1],
                       "shape": list(t.shape), "offset": offset,
                       "nbytes": len(raw)})
        blobs.append(raw)
        offset += len(raw)
    head = json.dumps(header).encode()
    raw = _HEADER_LEN.pack(len(head)) + head + b"".join(blobs)
    return zlib.compress(raw, 3), len(header)


def _decode(data: bytes, device: torch.device) -> Dict[str, torch.Tensor]:
    raw = zlib.decompress(data)
    (n,) = _HEADER_LEN.unpack_from(raw)
    start = _HEADER_LEN.size + n
    body = torch.frombuffer(bytearray(raw[start:]), dtype=torch.uint8)
    out = {}
    for spec in json.loads(raw[_HEADER_LEN.size:start]):
        # a copy starts at offset 0, which a wider dtype's view needs
        words = body[spec["offset"]:spec["offset"] + spec["nbytes"]].clone()
        out[spec["key"]] = words.view(getattr(torch, spec["dtype"])).reshape(
            spec["shape"]).to(device)
    return out


def save(ckpt_dir: str, step: int, tree: Any, extra: Optional[dict] = None,
         keep: int = 3) -> str:
    """Write ``tree`` (and the JSON-able ``extra``) as step ``step``; keep
    the newest ``keep`` steps. Returns the step's directory.

    In a process group every rank calls it: DTensor leaves are gathered
    by all, rank 0 writes, and the ranks meet at a barrier after the
    write, so a restore that follows finds the step."""
    step_dir = os.path.join(ckpt_dir, f"step_{step:08d}")
    comp, n_arrays = _encode(tree)
    group = _world()
    if group is not None and group.get_rank() != 0:
        group.barrier()
        return step_dir
    tmp_dir = step_dir + ".tmp"
    os.makedirs(tmp_dir, exist_ok=True)
    with open(os.path.join(tmp_dir, "shard_0.ckpt"), "wb") as f:
        f.write(comp)
    manifest = {"step": step, "n_arrays": n_arrays, "extra": extra or {},
                "hosts": 1}
    with open(os.path.join(tmp_dir, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(step_dir):
        shutil.rmtree(step_dir)
    os.rename(tmp_dir, step_dir)
    _gc(ckpt_dir, keep)
    if group is not None:
        group.barrier()
    return step_dir


def _world():
    """``torch.distributed`` when a default process group of more than
    one rank is open, else None."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized() \
            and dist.get_world_size() > 1:
        return dist
    return None


def _gc(ckpt_dir: str, keep: int) -> None:
    steps = all_steps(ckpt_dir)
    for s in steps[:-keep] if keep > 0 else []:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:08d}"),
                      ignore_errors=True)


def all_steps(ckpt_dir: str) -> List[int]:
    """The steps with a manifest, ascending."""
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for name in os.listdir(ckpt_dir):
        if name.startswith("step_") and not name.endswith(".tmp"):
            if os.path.exists(os.path.join(ckpt_dir, name, "manifest.json")):
                out.append(int(name[5:]))
    return sorted(out)


def latest_step(ckpt_dir: str) -> Optional[int]:
    steps = all_steps(ckpt_dir)
    return steps[-1] if steps else None


def restore(ckpt_dir: str, step: int, like: Any,
            device: DeviceLike = None, shardings: Any = None
            ) -> Tuple[Any, dict]:
    """Step ``step`` in the structure of ``like``, every tensor on
    ``device`` (None = CUDA), and the ``extra`` it was saved with.
    ``shardings``: a tree like ``like`` whose leaves are ``(mesh, spec)``
    (a ``sharding.rules`` spec or DTensor placements; e.g.
    ``rules.tree_shardings``) or None: each array is placed on that mesh
    as a DTensor (every rank of the mesh calls ``restore``)."""
    dev = resolve_device(device)
    step_dir = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(step_dir, "manifest.json")) as f:
        manifest = json.load(f)
    with open(os.path.join(step_dir, "shard_0.ckpt"), "rb") as f:
        arrays = _decode(f.read(), dev)
    missing = [k for k, _ in _items(like) if k not in arrays]
    if missing:
        raise ValueError(f"checkpoint missing arrays: {sorted(missing)[:5]}")
    return _rebuild(like, arrays, shardings), manifest["extra"]
