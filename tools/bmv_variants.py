#!/usr/bin/env python3
"""Time variants of the ``bmv_bff`` and ``bmv_bbf`` kernels on one GPU.

Run from the repository root:

    python3 tools/bmv_variants.py            # R-MAT scale 21, t = 32
    python3 tools/bmv_variants.py --scale 16

Each variant is a copy of ``src/repro_torch/kernels/bmv/bmv.cu`` with one
of its tuning constants changed, written to ``build/bmv_variants/`` and
built with ``nvcc`` like the source itself. ``bmv_bff`` is timed (CUDA
events, median of 15) in sum and min-plus mode on a PageRank-like input
(x = 1 / (n · degree), 30% inf for min-plus) with the work items the
registry keeps; ``bmv_bbf`` on each iteration's frontier of one BFS. Every
variant is checked against the plain version (min-plus and counts bit for
bit, sum within 1e-5 relative) and timed twice, in order and in reverse.
Prints the card's name and power limit, each variant's registers (from
``ptxas -v``) and one JSON line of times.
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


def variant_source(changes) -> str:
    text = SOURCE.read_text()
    for name, value in changes.items():
        head = f"constexpr int {name} = "
        start = text.index(head) + len(head)
        end = text.index(";", start)
        text = text[:start] + str(value) + text[end:]
    return text


def registers(log: str):
    """Registers of the t = 32 bmv_bff (sum) and bmv_bbf kernels."""
    out, cur = {}, ""
    for line in log.splitlines():
        if "Compiling entry function" in line:
            cur = line.split("'")[1]
        elif "Used" in line:
            for key, mangled in (("bmv_bff", "bmv_bff_kernelILi32ELi0"),
                                 ("bmv_bbf", "bmv_bbf_kernelILi32")):
                if mangled in cur:
                    out[key] = int(line.split("Used")[1].split()[0])
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--scale", type=int, default=21)
    scale = parser.parse_args().scale
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

    out_dir = ROOT / "build" / "bmv_variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    paths = {}
    for name, changes in VARIANTS.items():
        path = out_dir / f"bmv_{name}.cu"
        path.write_text(variant_source(changes))
        paths[name] = path
    with ThreadPoolExecutor(len(paths)) as pool:
        list(pool.map(common.load_library, paths.values()))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    regs = {name: registers(common.BUILD_LOG.get(p.stem, ""))
            for name, p in paths.items()}

    n = 1 << scale
    rows, cols = rmat_graph(n, avg_degree=2 * cs.EDGEFACTOR, seed=cs.SEED)
    g = GraphMatrix.from_coo(rows, cols, n, n, cs.TILE_DIM,
                             backend="b2sr_cuda", device="cuda")
    gt = g.transposed()
    m = gt.b2sr
    args, t = cs.b2sr_args(m), m.tile_dim
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
    source = int(np.random.default_rng(cs.SEED + 1).choice(
        np.flatnonzero(np.bincount(rows, minlength=n)), cs.N_SOURCES,
        replace=False)[0])
    levels = bfs(g, source)
    fronts = [f.words for f in cs.frontiers(gt, levels.levels,
                                            levels.n_iterations)]
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
