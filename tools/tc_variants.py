#!/usr/bin/env python3
"""Time variants of the ``bmm_tc`` kernel (triangle counting) on one GPU.

Run from the repository root:

    python3 tools/tc_variants.py            # L of R-MAT scale 21, t = 32
    python3 tools/tc_variants.py --scale 16

L, the strict lower triangle of the Graph500 R-MAT graph that
``chip_smoke.py`` builds, goes through ``bmm_tc(L, L, L)`` with:

  - the count stage on or off (without it the probes run alone and the
    total is 0: what the probes cost);
  - the items' probes (``bmm.ITEM_PROBES``) and the plan's split by the
    shorter row on or off (``bmm.tc_plan``; each plan built once, its
    time printed apart);
  - copies of ``bmm.cu`` with other constants (entries a warp queues,
    entries a lane loads before its popcounts, blocks an SM should hold),
    written to ``build/tc_variants/`` and built with ``nvcc`` like the
    source.

Every variant that counts must give the plain version's total. Each is
timed with CUDA events (median of 3) in order and in reverse. Prints the
card's name and power limit, L's row lengths, the work counts (probes,
(mask bit, common tile) pairs, entries queued for the count, the least
merge walk) and one JSON line of times.
"""

from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

SOURCE = ROOT / "src/repro_torch/kernels/bmm/bmm.cu"
HEADER = ROOT / "src/repro_torch/kernels/row_bitmap.cuh"
#: source variants: {constant: value} of ``bmm.cu``'s ``constexpr int``s
SOURCES = {
    "default": {},
    "ahead_2": {"kAhead": 2},
    "drain_1": {"kDrainUnroll": 1},
    "blocks_5": {"kBlocksPerSm": 5},
}
#: run variants of the default source: name -> (count stage, items'
#: probes, shorter-row split)
RUNS = {
    "default": (True, "probes", True),
    "one_walk": (True, "probes", False),
    "probes_only": (False, "probes", True),
    "probes_only_one_walk": (False, "probes", False),
    "items_32768": (True, 1 << 15, True),
    "items_131072": (True, 1 << 17, True),
}


def variant_source(changes) -> str:
    text = SOURCE.read_text()
    for name, value in changes.items():
        head = f"constexpr int {name} = "
        start = text.index(head) + len(head)
        end = text.index(";", start)
        text = text[:start] + str(value) + text[end:]
    return text


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--scale", type=int, default=21)
    scale = parser.parse_args().scale
    import torch
    if not torch.cuda.is_available():
        print("tc_variants: CUDA is not available", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch.core.graphblas import GraphMatrix, LowerTriangle
    from repro_torch.data.graphs import rmat_graph
    from repro_torch.kernels import common
    from repro_torch.kernels.bmm import bmm, ref

    # the copies include "../row_bitmap.cuh": keep that path
    out_dir = ROOT / "build" / "tc_variants"
    (out_dir / "bmm").mkdir(parents=True, exist_ok=True)
    shutil.copy(HEADER, out_dir / HEADER.name)
    paths = {}
    for name, changes in SOURCES.items():
        path = out_dir / "bmm" / f"bmm_{name}.cu"
        path.write_text(variant_source(changes))
        paths[name] = path
    with ThreadPoolExecutor(len(paths)) as pool:
        list(pool.map(common.load_library, paths.values()))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())

    n = 1 << scale
    rows, cols = rmat_graph(n, avg_degree=2 * cs.EDGEFACTOR, seed=cs.SEED)
    g = GraphMatrix.from_coo(rows, cols, n, n, cs.TILE_DIM,
                             backend="b2sr_cuda", device="cuda")
    del rows, cols
    low = LowerTriangle(g.csr, g.tile_dim, n).b2sr
    lens = (low.tile_row_ptr[1:] - low.tile_row_ptr[:-1]).long()
    probes = int(lens[low.tile_col_idx.long()].sum())
    plain = int(ref.bmm_tc(low, low, low))
    _, work, queued = bmm._bmm_tc(low, low, low, True, True, None)
    info = {"n_tiles": low.n_tiles, "max_tiles_per_row": int(lens.max()),
            "probes": probes, "mask_bit_tile_pairs": int(work),
            "queued_entries": int(queued),
            "min_walk": bmm.min_walk(low, low, low), "triangles": plain}
    print(json.dumps(info))

    plans, plan_s = {}, {}
    for _, item_probes, shorter in RUNS.values():
        key = (item_probes, shorter)
        if key not in plans:
            plans[key], plan_s[str(key)] = cs.sync_time(
                lambda: bmm.tc_plan(low, low, low,
                                    bmm.ITEM_PROBES if item_probes == "probes"
                                    else item_probes, shorter))

    def call(count, item_probes, shorter):
        return bmm._bmm_tc(low, low, low, False, count,
                           plans[item_probes, shorter])

    cases = [("default", run) for run in RUNS] + \
        [(src, "default") for src in SOURCES if src != "default"]
    times = {f"{src}/{run}": [] for src, run in cases}
    ok = {key: True for key in times}
    for order in (cases, list(reversed(cases))):
        for src, run in order:
            key = f"{src}/{run}"
            bmm.SOURCE = paths[src]
            args = RUNS[run]
            if args[0]:
                ok[key] &= int(call(*args)) == plain
            times[key].append(cs.event_ms(lambda: call(*args), reps=3))
    bmm.SOURCE = SOURCE
    regs = {name: common.kernel_resources(p.stem)
            for name, p in paths.items()}
    print(json.dumps({"scale": scale, "sources": SOURCES, "runs": RUNS,
                      "plan_s": plan_s, "resources": regs, "ok": ok,
                      "times": times}))
    return 0 if all(ok.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
