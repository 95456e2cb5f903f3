"""Dry run of the production meshes: place and step every LM cell on the
16 × 16 and 2 × 16 × 16 meshes with no device, the port of
``repro.launch.dryrun``.

For each cell a fake world of 256 or 512 ranks is opened (this process
plays rank 0, see ``launch.mesh.fake_world``), the parameters, optimizer
state and inputs (meta tensors: shapes only, nothing allocated) are
placed by the rules as DTensors with meta local shards, and the step runs
once under ``launch.op_cost``'s counter. Meta tensors stand where the
reference would have a ``FakeTensorMode``: DTensor's propagation of a
strided shard (a sequence-sharded residual flattened into a matmul)
reads a value with ``.item()``, which no fake tensor can give. The
record is one rank's: argument bytes (its local shards), output bytes,
peak bytes (the counter's own tracking of live storage), flops, bytes
and collectives by op, with the cell's ``meta``, the layers counted and
the seconds taken. One JSON file a cell goes to ``--out``.

Every layer runs: each is its own module, so no count needs a trip-count
multiplier. Counts at 1 and 2 layers would extend linearly for flops,
bytes and collectives, but not for the peak, the larger of one layer's
transient and what all the layers keep: extended from 2 layers, a 32k
prefill's peak misses most of its caches.

Only the LM cells run: a GNN or DIN cell asked for by ``--arch`` /
``--shape`` raises ``NotImplementedError`` (ROADMAP Queue 1 item 10.4
ports them); under ``--all`` they are named as not yet ported and never
counted as passed.

Usage:
  python -m repro_torch.launch.dryrun --arch phi4-mini-3.8b --shape train_4k
  python -m repro_torch.launch.dryrun --all                 # both meshes
  python -m repro_torch.launch.dryrun --all --mesh single
"""

from __future__ import annotations

import argparse
import json
import math
import os
import time
import traceback
from typing import Any, Optional, Sequence

import torch

from repro_torch.configs import SKIPPED_CELLS, TransformerConfig, all_cells
from repro_torch.configs import get_config
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch import op_cost
from repro_torch.launch.specs import build_cell
from repro_torch.sharding import spmd

_NOT_PORTED = "ROADMAP Queue 1 item 10.4"


def _is_lm(arch: str) -> bool:
    return isinstance(get_config(arch), TransformerConfig)


def _rebuild(like, items):
    """A tuple, list or named tuple of ``items`` like ``like``."""
    items = list(items)
    return type(like)(*items) if hasattr(like, "_fields") \
        else type(like)(items)


def _constrain_out(out: Any, spec_tree: Any) -> Any:
    """The step's outputs redistributed to the cell's out specs (the
    reference's ``out_shardings``); None specs leave a leaf as it is."""
    if spec_tree is None or out is None:
        return out
    if isinstance(out, torch.Tensor):
        return spmd.constrain(out, spec_tree)
    if isinstance(out, dict):
        return {k: _constrain_out(v, spec_tree[k] if spec_tree else None)
                for k, v in out.items()}
    return _rebuild(out, (_constrain_out(v, s)
                          for v, s in zip(out, spec_tree)))


def _local_bytes(tree: Any) -> int:
    from torch.utils._pytree import tree_leaves
    total = 0
    for x in tree_leaves(tree):
        if isinstance(x, torch.Tensor):
            x = x.to_local() if spmd.is_dtensor(x) else x
            total += x.numel() * x.element_size()
    return total


def _count(cell, mesh):
    """One counted run of the cell's step over its arguments placed as
    meta DTensors: ``(CostReport, argument bytes, output bytes)``."""
    args = list(spmd.place_tree(cell.args, mesh, cell.in_specs))
    arg_bytes = _local_bytes(args)
    if cell.kind == "decode":
        # the cache length: one token against a full cache
        args[-1] = int(cell.args[2].shape[2]) - 1
    with op_cost.counting(live=_tensor_leaves(args)) as rep:
        out = _constrain_out(cell.step(*args), cell.out_specs)
    return rep, arg_bytes, _local_bytes(out)


def run_cell(arch: str, shape_id: str, multi_pod: bool, out_dir: str,
             overrides: Optional[dict] = None, tag: str = "",
             mesh_shape: Optional[Sequence[int]] = None) -> dict:
    """One cell on the production mesh (or, with ``mesh_shape``, on a
    ``("data", "model")`` mesh of that shape) in a fake world of its
    size; returns the record it writes."""
    if not _is_lm(arch):
        raise NotImplementedError(
            f"{arch} × {shape_id}: the GNN and DIN dry-run cells are not "
            f"ported yet ({_NOT_PORTED})")
    from torch.distributed.device_mesh import init_device_mesh
    if mesh_shape is None:
        shape = (2, 16, 16) if multi_pod else (16, 16)
        mesh_name = "2x16x16" if multi_pod else "16x16"
    else:
        shape = tuple(mesh_shape)
        mesh_name = "x".join(map(str, shape))
    n_ranks = math.prod(shape)
    t0 = time.perf_counter()
    with mesh_mod.fake_world(n_ranks):
        if mesh_shape is None:
            mesh = mesh_mod.make_production_mesh(multi_pod, device_type="cpu")
        else:
            mesh = init_device_mesh("cpu", shape,
                                    mesh_dim_names=("data", "model"))
        cell = build_cell(arch, shape_id, mesh, overrides=overrides)
        rep, arg_bytes, out_bytes = _count(cell, mesh)
    n_layers = int((overrides or {}).get("n_layers",
                                         get_config(arch).n_layers))
    seconds = time.perf_counter() - t0

    result = {
        "arch": arch, "shape": shape_id, "kind": cell.kind,
        "mesh": mesh_name, "n_chips": n_ranks,
        "seconds": seconds, "layers_counted": n_layers,
        "memory": {"argument_bytes": arg_bytes, "output_bytes": out_bytes,
                   "peak_bytes": rep.peak_bytes},
        "flops_per_device": rep.flops,
        "bytes_per_device": rep.hbm_bytes,
        "ops_per_device": rep.n_ops,
        "collectives": {"per_device_wire_bytes": rep.wire_bytes,
                        "by_op": rep.wire_by_op},
        "meta": cell.meta,
        "status": "ok",
    }
    if overrides:
        result["overrides"] = {k: str(v) for k, v in overrides.items()}
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        suffix = f"__{tag}" if tag else ""
        fname = f"{arch}__{shape_id}__{mesh_name}{suffix}.json"
        with open(os.path.join(out_dir, fname), "w") as f:
            json.dump(result, f, indent=1)
    print(f"== {arch} × {shape_id} on {mesh_name} ({seconds:.1f}s) ==")
    print(f"  memory: {result['memory']}")
    print(f"  flops/device: {rep.flops:.3e}  bytes/device: "
          f"{rep.hbm_bytes:.3e}")
    print(f"  collectives: {rep.wire_by_op}", flush=True)
    return result


def _tensor_leaves(tree: Any):
    from torch.utils._pytree import tree_leaves
    return [x for x in tree_leaves(tree) if isinstance(x, torch.Tensor)]


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--mesh", choices=("single", "multi", "both"),
                    default="both")
    ap.add_argument("--out", default="results/dryrun_torch")
    ap.add_argument("--set", action="append", default=[], dest="overrides",
                    help="config override key=value")
    ap.add_argument("--tag", default="", help="suffix for the output json")
    args = ap.parse_args(argv)

    overrides = {}
    for kv in args.overrides:
        k, v = kv.split("=", 1)
        overrides[k] = {"true": True, "false": False}.get(
            v.lower(), int(v) if v.lstrip("-").isdigit() else v)

    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    if args.all:
        cells = list(all_cells())
        not_ported = [c for c in cells if not _is_lm(c[0])]
        cells = [c for c in cells if _is_lm(c[0])]
        print(f"-- not yet ported ({_NOT_PORTED}), not run: "
              + ", ".join(f"{a} × {s}" for a, s in not_ported))
    else:
        cells = [(args.arch, args.shape)]

    failures = []
    n_run = 0
    for arch, shape_id in cells:
        if (arch, shape_id) in SKIPPED_CELLS:
            print(f"-- skipping {arch} × {shape_id} (DESIGN.md §6)")
            continue
        for mp in meshes:
            try:
                run_cell(arch, shape_id, mp, args.out,
                         overrides=overrides or None, tag=args.tag)
                n_run += 1
            except NotImplementedError:
                raise
            except Exception as e:
                failures.append((arch, shape_id, mp, repr(e)))
                print(f"!! FAILED {arch} × {shape_id} multi_pod={mp}: {e}")
                traceback.print_exc()
    if failures:
        print(f"\n{len(failures)} FAILURES:")
        for f in failures:
            print("  ", f)
        raise SystemExit(1)
    print(f"\n{n_run} LM cell runs")
    print("ALL DRY-RUN CELLS PASSED")


if __name__ == "__main__":
    main()
