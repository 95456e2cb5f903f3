#!/usr/bin/env python3
"""Time variants of the ``spmm_dense``, ``spmm_bbf`` or ``spmm_bbb`` kernel
on one GPU.

Run from the repository root:

    python3 tools/spmm_variants.py            # spmm_dense, R-MAT scale 21
    python3 tools/spmm_variants.py --scale 16
    python3 tools/spmm_variants.py --kernel bbf
    python3 tools/spmm_variants.py --kernel bbb

Each variant is a copy of ``src/repro_torch/kernels/spmm/spmm.cu`` with
some of its tuning constants changed (entries staged per round, and for
each V the entries whose reads of X a lane issues together and the
blocks per SM), written to ``build/spmm_variants/`` and built with
``nvcc`` like the source itself. Every variant runs each V (columns a
lane takes per pass) on a uniform [0, 1) X of D = 32 (batched PPR's
width), 64 and 128 (the widths at which ``spmm.dense_vec`` picks V = 2
and 4) and 1,433 (gcn-cora's input layer), with the work items the
registry keeps; it is checked against the plain version at D <= 128
(within 1e-5 of A·|X|) and against the default source at D = 1,433
(within 1e-4 relative: another stage size adds in other groups), and
timed (CUDA events, median of 5 at D <= 128, of 1 after a warm-up at
D = 1,433) in order and in reverse. Prints the card's name and power
limit, each variant's registers and spill stores and loads per V (from
``ptxas -v``) and one JSON line of times.

``--kernel bbf`` does the same for ``spmm_bbf``: each variant of its
constants (entries staged a warp, entries a lane group loads before its
adds) runs with each work-item cut of
:data:`BBF_CUTS` on random ``BitMatrix`` words (half the bits set) of
D = 16 (gcn-cora's hidden width) and 130, checked bit for bit against
the plain version and timed (median of 5) in order and in reverse.

``--kernel bbb`` does the same for ``spmm_bbb``: each variant of its
constants (entries staged a warp, entries a lane group loads before its
ORs, batches of 32 tiles whose column indices and frontier words a
warp reads at once, blocks an SM should hold) runs with each work-item cut of
:data:`BBB_CUTS` on the inputs of every iteration of an msbfs (auto) of
64 sources, as ``chip_smoke.py``'s ``spmm_timing`` phase builds them
(frontier and visited mask over the stored transpose), checked bit for
bit against the plain version and timed (median of 5 a launch, the mean
over the iterations) in order and in reverse.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import statistics
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
# X at D = 1,433 and two products of it take 36 GB: leave the allocator
# room to reuse freed blocks of another size
os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

SOURCE = ROOT / "src/repro_torch/kernels/spmm/spmm.cu"
WIDTHS = (32, 64, 128, 1433)
#: variant name -> {constant: value}: ``kStage`` an int, ``entries`` and
#: ``blocks`` (``DenseTune``) one value for each of V = 1, 2, 4, 8;
#: "default" is the source as it is
VARIANTS = {
    "default": {},
    "entries_16": {"entries": (16, 8, 4, 2)},
    "entries_12": {"entries": (12, 12, 12, 6)},
    "wide_deeper": {"entries": (8, 8, 10, 6), "blocks": (8, 8, 5, 4)},
    "stage_512": {"kStage": 512, "blocks": (10, 8, 6, 5)},
}


#: spmm_bbf variants: {constant: value} of its ``constexpr int`` constants
BBF_VARIANTS = {
    "default": {},
    "stage_384": {"kBbfStage": 384},
}
#: spmm_bbf work-item cuts: (budget, by_bits)
BBF_CUTS = ((256, False), (512, True), (768, True))
BBF_WIDTHS = (16, 130)
#: spmm_bbb variants: {constant: value} of its ``constexpr int`` constants
BBB_VARIANTS = {
    "default": {},
    "unroll_1": {"kBbbUnroll": 1},
    "unroll_4": {"kBbbUnroll": 4},
    "stage_256": {"kBbbStage": 256},
    "ahead_4": {"kBbbAhead": 4},
    "blocks_6": {"kBbbBlocks": 6},
}
#: spmm_bbb work-item cuts, in tiles
BBB_CUTS = (128, 256, 512, 1024)


def variant_source(changes) -> str:
    text = SOURCE.read_text()
    for name, value in changes.items():
        if name.startswith("k"):       # a constexpr int of the file
            head = f"constexpr int {name} = "
        else:       # a DenseTune member: one value for each V
            head = f"static constexpr int {name} = "
            value = "V == 1 ? {} : V == 2 ? {} : V == 4 ? {} : {}".format(
                *value)
        start = text.index(head) + len(head)
        end = text.index(";", start)
        text = text[:start] + str(value) + text[end:]
    return text


def resources(stem: str, t: int):
    """Registers and spill stores and loads of the ``spmm_dense`` kernel
    of tile dim ``t``, by V."""
    from repro_torch.kernels import common
    out = {}
    for name, r in common.kernel_resources(stem).items():
        hit = re.search(r"spmm_dense_kernelILi(\d+)ELi(\d+)E", name)
        if hit and int(hit[1]) == t:
            out[int(hit[2])] = r
    return out


def build(variants, stem: str):
    """Write and build each variant's source; print the card's line."""
    from repro_torch.kernels import common
    out_dir = ROOT / "build" / "spmm_variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    paths = {}
    for name, changes in variants.items():
        path = out_dir / f"{stem}_{name}.cu"
        path.write_text(variant_source(changes))
        paths[name] = path
    with ThreadPoolExecutor(len(paths)) as pool:
        list(pool.map(common.load_library, paths.values()))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    return paths


def rmat(scale: int):
    import chip_smoke as cs
    from repro_torch.core.graphblas import GraphMatrix
    from repro_torch.data.graphs import rmat_graph
    n = 1 << scale
    rows, cols = rmat_graph(n, avg_degree=2 * cs.EDGEFACTOR, seed=cs.SEED)
    return GraphMatrix.from_coo(rows, cols, n, n, cs.TILE_DIM,
                                backend="b2sr_cuda", device="cuda")


def bbf_main(scale: int) -> int:
    """The spmm_bbf variants (see the module's docstring)."""
    import torch
    import chip_smoke as cs
    from repro_torch.core.b2sr import pack_bitmatrix
    from repro_torch.kernels import common
    from repro_torch.kernels.items import work_items
    from repro_torch.kernels.spmm import ref, spmm

    paths = build(BBF_VARIANTS, "bbf")
    g = rmat(scale)
    m = g.b2sr
    regs = {}
    for name, path in paths.items():
        for kname, r in common.kernel_resources(path.stem).items():
            if re.search(r"spmm_bbf_kernelILi32E", kname):
                regs[name] = r
    cuts = {f"{'bits' if by_bits else 'tiles'}_{budget}":
            work_items(m, budget, by_bits) for budget, by_bits in BBF_CUTS}
    n_items = {k: c.n_items for k, c in cuts.items()}
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
    xws = {d: pack_bitmatrix(torch.rand((g.n_cols, d), generator=gen,
                                        device="cuda") < 0.5, m.tile_dim)
           for d in BBF_WIDTHS}
    want = {d: ref.spmm_bbf(m, xws[d], torch.int32) for d in BBF_WIDTHS}
    times = {name: {d: {k: [] for k in cuts} for d in BBF_WIDTHS}
             for name in paths}
    ok = {name: True for name in paths}
    for order in (list(paths), list(reversed(paths))):
        for name in order:
            spmm.SOURCE = paths[name]
            for d in BBF_WIDTHS:
                for key, items in cuts.items():
                    y = spmm.spmm_bbf(m, xws[d], torch.int32, items=items)
                    ok[name] &= bool(torch.equal(y, want[d]))
                    times[name][d][key].append(cs.event_ms(
                        lambda d=d, items=items: spmm.spmm_bbf(
                            m, xws[d], torch.int32, items=items), reps=5))
    spmm.SOURCE = SOURCE
    print(json.dumps({"kernel": "spmm_bbf", "scale": scale,
                      "variants": BBF_VARIANTS, "n_items": n_items,
                      "resources": regs, "ok": ok, "times": times}))
    return 0 if all(ok.values()) else 1


def bbb_main(scale: int) -> int:
    """The spmm_bbb variants (see the module's docstring)."""
    import numpy as np
    import torch
    import chip_smoke as cs
    from repro_torch.core.b2sr import pack_frontier_matrix
    from repro_torch.engine import msbfs
    from repro_torch.kernels import common
    from repro_torch.kernels.items import work_items
    from repro_torch.kernels.spmm import ref, spmm

    paths = build(BBB_VARIANTS, "bbb")
    g = rmat(scale)
    regs = {}
    for name, path in paths.items():
        for kname, r in common.kernel_resources(path.stem).items():
            if re.search(r"spmm_bbb_kernelILi32E", kname):
                regs[name] = r
    deg = g.degrees().cpu().numpy()
    sources = [int(v) for v in np.random.default_rng(cs.SEED + 1).choice(
        np.flatnonzero(deg), cs.N_SOURCES, replace=False)]
    res = msbfs(g, cs.engine_sources(deg, sources), direction="auto")
    m = g.transposed().b2sr
    t, n = m.tile_dim, g.n_rows
    inputs = []
    for it in range(res.n_iterations):
        f = pack_frontier_matrix(res.levels == it, t, n)
        vis = pack_frontier_matrix((res.levels >= 0) & (res.levels <= it),
                                   t, n)
        inputs.append((f, vis, ref.spmm_bbb(m, f, vis)))
    cuts = {b: work_items(m, b) for b in BBB_CUTS}
    times = {name: {b: [] for b in BBB_CUTS} for name in paths}
    ok = {name: True for name in paths}
    for order in (list(paths), list(reversed(paths))):
        for name in order:
            spmm.SOURCE = paths[name]
            for b, items in cuts.items():
                per_it = []
                for f, vis, want in inputs:
                    ok[name] &= bool(torch.equal(
                        spmm.spmm_bbb(m, f, vis, items=items), want))
                    per_it.append(cs.event_ms(
                        lambda f=f, vis=vis, items=items: spmm.spmm_bbb(
                            m, f, vis, items=items), reps=5))
                times[name][b].append(statistics.fmean(per_it))
    spmm.SOURCE = SOURCE
    print(json.dumps({"kernel": "spmm_bbb", "scale": scale,
                      "iterations": res.n_iterations,
                      "variants": BBB_VARIANTS,
                      "n_items": {b: c.n_items for b, c in cuts.items()},
                      "resources": regs, "ok": ok,
                      "mean_ms_per_launch": times}))
    return 0 if all(ok.values()) else 1


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--scale", type=int, default=21)
    parser.add_argument("--kernel", choices=("dense", "bbf", "bbb"),
                        default="dense")
    args = parser.parse_args()
    scale = args.scale
    import torch
    if not torch.cuda.is_available():
        print("spmm_variants: CUDA is not available", file=sys.stderr)
        return 1
    if args.kernel == "bbf":
        return bbf_main(scale)
    if args.kernel == "bbb":
        return bbb_main(scale)
    import chip_smoke as cs
    from repro_torch.kernels.items import items_for
    from repro_torch.kernels.spmm import ref, spmm

    paths = build(VARIANTS, "spmm")
    n = 1 << scale
    g = rmat(scale)
    m = g.b2sr
    regs = {name: resources(p.stem, m.tile_dim)
            for name, p in paths.items()}
    items = items_for(g, spmm.DENSE_ITEM_WORK, by_bits=True)
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
    xs = {d: torch.rand((n, d), generator=gen, device="cuda")
          for d in WIDTHS}
    small = [d for d in WIDTHS if d <= 128]
    want = {d: ref.spmm_dense(m, xs[d]) for d in small}   # X >= 0: A·|X|
    spmm.SOURCE = paths["default"]
    want1433 = spmm.spmm_dense(m, xs[1433], items=items)

    times = {name: {d: {v: [] for v in spmm.DENSE_VECS} for d in WIDTHS}
             for name in paths}
    ok = {name: True for name in paths}
    for order in (list(paths), list(reversed(paths))):
        for name in order:
            spmm.SOURCE = paths[name]
            for v in spmm.DENSE_VECS:
                for d in small:
                    y = spmm._spmm_dense(m, xs[d], items, v)
                    ok[name] &= bool(((y.double() - want[d].double()).abs()
                                      <= cs.SUM_TOL * want[d].double()).all())
                y = spmm._spmm_dense(m, xs[1433], items, v)
                for i in range(0, n, 1 << 16):   # in slices: 12 GB each
                    a, b = y[i:i + (1 << 16)], want1433[i:i + (1 << 16)]
                    ok[name] &= bool(((a - b).abs() <= 1e-4 * b.abs()).all())
                del y
                for d in WIDTHS:
                    times[name][d][v].append(cs.event_ms(
                        lambda d=d, v=v: spmm._spmm_dense(
                            m, xs[d], items, v),
                        reps=1 if d == 1433 else 5))
    spmm.SOURCE = SOURCE
    print(json.dumps({"scale": scale, "variants": VARIANTS,
                      "resources": regs, "ok": ok, "times": times}))
    return 0 if all(ok.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
