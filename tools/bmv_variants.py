#!/usr/bin/env python3
"""Time variants of the ``bmv_bff``, ``bmv_bbf`` and ``bmv_bbb_pull``
kernels on one GPU.

Run from the repository root:

    python3 tools/bmv_variants.py                 # R-MAT scale 21, t = 32
    python3 tools/bmv_variants.py --scale 16
    python3 tools/bmv_variants.py --kernel pull   # pull's cadence and cut
    python3 tools/bmv_variants.py --kernel pull --baseline OTHER/bmv.cu

Each variant is a copy of ``src/repro_torch/kernels/bmv/bmv.cu`` with one
of its tuning constants changed, written to ``build/bmv_variants/`` and
built with ``nvcc`` like the source itself. ``bmv_bff`` is timed (CUDA
events, median of 15) in sum and min-plus mode on a PageRank-like input
(x = 1 / (n · degree), 30% inf for min-plus) with the work items the
registry keeps; ``bmv_bbf`` on each iteration's frontier of one BFS.
With ``--kernel pull``, ``bmv_bbb_pull`` is timed on each of that BFS's
frontiers under its visited mask (complemented), as the pull direction
runs it, with the lane occupancy the registry keeps: each cadence
variant (exit tests, shares of a cut row's word once the item has a
hit and before, batches loaded together, live tiles read at once, the
register cap) with the registry's cut, the source's own cadence with cuts of 64, 256 and 1,024 tiles and
without the lane occupancy, and push's kernel on the same inputs (the
floor to beat), and with ``--baseline`` the push of another ``bmv.cu``
(an earlier checkout's, which takes the same arguments) beside it, in
the same passes. Every variant is
checked against the plain version (min-plus, counts and the pull steps
bit for bit, sum within 1e-5 relative) and timed twice, in order and in
reverse. Prints the card's name and power limit, each variant's
registers (from ``ptxas -v``) and one JSON line of times.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

SOURCE = ROOT / "src/repro_torch/kernels/bmv/bmv.cu"
#: variant name -> {constant: value}; "default" is the source as it is
VARIANTS = {
    "default": {},
    "bff_unroll_8": {"kUnroll": 8},
    "bff_unroll_16": {"kUnroll": 16},
    "bbf_uncapped": {"kCountBlocksPerSM": 1},
    "bbf_batches_1": {"kCountBatches": 1},
    "bbf_batches_8": {"kCountBatches": 8},
    "bbf_unroll_4": {"kCountUnroll": 4},
    "bbf_unroll_16": {"kCountUnroll": 16},
}
#: pull's cadence variants (``--kernel pull``), the same way
PULL_VARIANTS = {
    "default": {},
    "exit_2": {"kPullExit": 2},
    "exit_4": {"kPullExit": 4},
    "share_2": {"kPullShare": 2},
    "share_4": {"kPullShare": 4},
    "idle_1": {"kPullShareIdle": 1},
    "idle_4": {"kPullShareIdle": 4},
    "group_1": {"kPullGroup": 1},
    "group_2": {"kPullGroup": 2},
    "unroll_4": {"kPullUnroll": 4},
    "group_2_unroll_2": {"kPullGroup": 2, "kPullUnroll": 2},
    "blocks_4": {"kPullBlocksPerSM": 4},
    "blocks_8": {"kPullBlocksPerSM": 8},
}
#: cuts (tiles an item) pull runs with the source's own cadence
PULL_CUTS = (64, 256, 1024)


def variant_source(changes) -> str:
    text = SOURCE.read_text()
    for name, value in changes.items():
        head = f"constexpr int {name} = "
        start = text.index(head) + len(head)
        end = text.index(";", start)
        text = text[:start] + str(value) + text[end:]
    return text


def registers(stem: str):
    """Registers and spill bytes of the t = 32 bmv_bff (sum), bmv_bbf,
    push and pull kernels of the library built from ``<stem>.cu``."""
    from repro_torch.kernels import common
    out = {}
    for name, res in common.kernel_resources(stem).items():
        for key, mangled in (("bmv_bff", "bmv_bff_kernelILi32ELi0"),
                             ("bmv_bbf", "bmv_bbf_kernelILi32"),
                             ("push", "bbb_walkILi32ENS_8PushWalk"),
                             ("pull", "bbb_walkILi32ENS_8PullWalk")):
            if mangled in name:
                out[key] = res
    return out


def build(variants, out_dir):
    """Write and build one source per variant: {name: path}."""
    from repro_torch.kernels import common
    out_dir.mkdir(parents=True, exist_ok=True)
    paths = {}
    for name, changes in variants.items():
        path = out_dir / f"bmv_{name}.cu"
        path.write_text(variant_source(changes))
        paths[name] = path
    with ThreadPoolExecutor(len(paths)) as pool:
        list(pool.map(common.load_library, paths.values()))
    return paths


def pull_variants(gt, fronts, visited, paths, baseline=None):
    """Pull on each BFS frontier under its visited mask, with the lane
    occupancy the registry keeps: every cadence variant with the
    registry's cut, the source's cadence with each cut of PULL_CUTS and
    with every lane taken as one a tile can set (no lane occupancy), and
    push (which takes none); {name: {"ms": [[per iteration] per pass],
    "ok": bool}}."""
    import torch
    import chip_smoke as cs
    from repro_torch.kernels.bmv import bmv, ref
    from repro_torch.kernels.items import items_for, lanes_for, work_items

    m = gt.b2sr
    args, t = cs.b2sr_args(m), m.tile_dim
    kept = items_for(gt, bmv.BBF_ITEM_WORK)
    lanes = {"lanes": lanes_for(gt)}
    cuts = {c: (kept if c == bmv.BBF_ITEM_WORK else work_items(m, c))
            for c in PULL_CUTS}
    wants = [ref.bmv_bbb_pull(*args, f, v, t=t) for f, v in
             zip(fronts, visited)]
    runs = {name: ("bmv_bbb_pull", path, kept, lanes)
            for name, path in paths.items()}
    runs.update({f"cut_{c}": ("bmv_bbb_pull", paths["default"], items,
                              lanes)
                 for c, items in cuts.items()})
    every_lane = torch.full_like(lanes["lanes"], -1)
    runs["no_lanes"] = ("bmv_bbb_pull", paths["default"], kept,
                        {"lanes": every_lane})
    runs["push"] = ("bmv_bbb_push", paths["default"], kept, {})
    if baseline is not None:
        runs["push_baseline"] = ("bmv_bbb_push", baseline, kept, {})
    times = {name: {"ms": [], "ok": True} for name in runs}
    for order in (list(runs), list(reversed(runs))):
        for name in order:
            kernel, path, items, extra = runs[name]
            bmv.SOURCE = path
            fn = getattr(bmv, kernel)
            row = times[name]
            row["ok"] &= all(
                torch.equal(fn(*args, f, v, t=t, items=items, **extra), w)
                for f, v, w in zip(fronts, visited, wants))
            row["ms"].append([cs.event_ms(
                lambda f=f, v=v: fn(*args, f, v, t=t, items=items, **extra))
                for f, v in zip(fronts, visited)])
    bmv.SOURCE = SOURCE
    for row in times.values():
        row["mean_ms"] = [statistics.fmean(p) for p in row["ms"]]
    return times




def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--scale", type=int, default=21)
    parser.add_argument("--kernel", choices=("bff_bbf", "pull"),
                        default="bff_bbf")
    parser.add_argument("--baseline", type=Path, default=None,
                        help="with --kernel pull: another bmv.cu whose "
                             "push is timed beside")
    opts = parser.parse_args()
    scale = opts.scale
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("bmv_variants: CUDA is not available", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch.algorithms import bfs
    from repro_torch.core.graphblas import GraphMatrix
    from repro_torch.data.graphs import rmat_graph
    from repro_torch.kernels import common
    from repro_torch.kernels.bmv import bmv, ref
    from repro_torch.kernels.items import items_for

    variants = VARIANTS if opts.kernel == "bff_bbf" else PULL_VARIANTS
    paths = build(variants, ROOT / "build" / "bmv_variants" / opts.kernel)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    regs = {name: registers(p.stem) for name, p in paths.items()}

    n = 1 << scale
    rows, cols = rmat_graph(n, avg_degree=2 * cs.EDGEFACTOR, seed=cs.SEED)
    g = GraphMatrix.from_coo(rows, cols, n, n, cs.TILE_DIM,
                             backend="b2sr_cuda", device="cuda")
    gt = g.transposed()
    m = gt.b2sr
    args, t = cs.b2sr_args(m), m.tile_dim
    source = int(np.random.default_rng(cs.SEED + 1).choice(
        np.flatnonzero(np.bincount(rows, minlength=n)), cs.N_SOURCES,
        replace=False)[0])
    levels = bfs(g, source)
    fronts = [f.words for f in cs.frontiers(gt, levels.levels,
                                            levels.n_iterations)]
    if opts.kernel == "pull":
        visited = [gt.pack_rows(((levels.levels >= 0)
                                 & (levels.levels <= it)).to(torch.int32))
                   for it in range(len(fronts))]
        baseline = None
        if opts.baseline is not None:
            baseline = opts.baseline.resolve()
            common.load_library(baseline)
        times = pull_variants(gt, fronts, visited, paths, baseline)
        print(json.dumps({"scale": scale, "kernel": "pull",
                          "variants": PULL_VARIANTS,
                          "cuts": list(PULL_CUTS), "registers": regs,
                          "times": times}))
        return 0 if all(r["ok"] for r in times.values()) else 1

    deg = g.degrees()
    x3 = cs.pad_x3((1.0 / n) / torch.where(deg == 0, 1.0, deg), t, 0.0)
    xm = x3.clone()
    rng = np.random.default_rng(cs.SEED)
    xm[torch.as_tensor(rng.random(xm.shape) < 0.3, device="cuda")] = \
        float("inf")
    bff_items = items_for(gt, bmv.BFF_ITEM_WORK, by_bits=True)
    bbf_items = items_for(gt, bmv.BBF_ITEM_WORK)
    want_sum = ref.bmv_bff(*args, x3, t=t, mode="sum")
    want_min = ref.bmv_bff(*args, xm, t=t, mode="min_plus")
    want_counts = [ref.bmv_bbf(*args, f, t=t) for f in fronts]

    times = {name: {"bff_sum_ms": [], "bff_min_plus_ms": [],
                    "bbf_mean_ms": [], "ok": True} for name in paths}
    for order in (list(paths), list(reversed(paths))):
        for name in order:
            bmv.SOURCE = paths[name]
            row = times[name]
            y = bmv.bmv_bff(*args, x3, t=t, mode="sum", items=bff_items)
            row["ok"] &= bool(((y - want_sum).abs()
                               <= 1e-5 * want_sum.abs()).all())
            row["ok"] &= torch.equal(bmv.bmv_bff(
                *args, xm, t=t, mode="min_plus", items=bff_items), want_min)
            row["ok"] &= all(torch.equal(bmv.bmv_bbf(
                *args, f, t=t, items=bbf_items), w)
                for f, w in zip(fronts, want_counts))
            row["bff_sum_ms"].append(cs.event_ms(lambda: bmv.bmv_bff(
                *args, x3, t=t, mode="sum", items=bff_items)))
            row["bff_min_plus_ms"].append(cs.event_ms(lambda: bmv.bmv_bff(
                *args, xm, t=t, mode="min_plus", items=bff_items)))
            row["bbf_mean_ms"].append(statistics.fmean(
                cs.event_ms(lambda f=f: bmv.bmv_bbf(*args, f, t=t,
                                                    items=bbf_items))
                for f in fronts))
    bmv.SOURCE = SOURCE
    print(json.dumps({"scale": scale, "variants": VARIANTS,
                      "registers": regs, "times": times}))
    return 0 if all(r["ok"] for r in times.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
