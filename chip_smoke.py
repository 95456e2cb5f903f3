#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``src/repro_torch/kernels`` and
drives the BFS slice through the port's entry points. Each phase prints
one JSON line; a failed phase exits non-zero.

  1. kernels: ``bmv_bbb_push`` and ``bmv_bbb_pull`` against their plain
     PyTorch versions (``kernels/bmv/ref.py``) on the card, bit for bit:
     tile dims 4/8/16/32 on small dot/rmat/road graphs and the full graph,
     frontiers at 0.1%/10%/60% density, masks with complement on and off.
  2. bfs: Graph500 R-MAT scale 21, edgefactor 16 (n = 2,097,152;
     A/B/C = 0.57/0.19/0.19; symmetrised, no self-loops), tile dim 32.
     ``direction`` push/pull/auto from 4 sources on ``b2sr_cuda`` (the
     main path; kernel launch counts are reset just before it and read
     just after), then on ``csr``: levels, n_iterations and directions
     must be equal, and levels must equal SciPy's unweighted
     ``shortest_path`` (-1 for unreachable). Prints each traversal's wall
     time and the median rate in traversed edges per second.
  3. timing: per kernel the median time of one launch (CUDA events) on
     each iteration's inputs of one traversal, beside its plain version,
     the ``csr`` row, one cuSPARSE SpMV call (``torch.mv`` on the float
     CSR) and the bound (bytes over 3.35 TB/s).
  4. profile: one traversal per direction under ``torch.profiler``:
     device time by kernel and the card's idle share of the wall time.

Then the card's name and power limit, the kernel table as one JSON line,
and last ``{"ok": true, "device": {...}}``. Without CUDA it exits 1
before printing any result.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
import warnings
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

SEED = 0
SCALE = 21
EDGEFACTOR = 16
TILE_DIM = 32
N_SOURCES = 4
DIRECTIONS = ("push", "pull", "auto")
DENSITIES = (0.001, 0.1, 0.6)
REPS = 15
HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
LANE_OPS_PER_S = 67e12         # H100 SXM 32-bit rate outside the tensor cores
KERNELS = {
    "bmv_bbb_push": "src/repro/kernels/bmv/bmv.py:96",
    "bmv_bbb_pull": "src/repro/kernels/bmv/bmv.py:170",
}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def fail(phase: str, msg: str) -> None:
    emit({"phase": phase, "ok": False, "error": msg})
    sys.exit(1)


def sync_time(fn):
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def event_ms(fn, reps: int = REPS) -> float:
    """Median time of one call of ``fn`` on the card (CUDA events)."""
    import torch
    fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def kernel_args(m, x, mask, comp):
    return (m.tile_row_ptr, m.tile_col_idx, m.bit_tiles, x, mask), \
        {"t": m.tile_dim, "complement": comp}


def phase_kernels(full_g, rng):
    """Each kernel against its plain version, bit for bit, on the card."""
    import torch
    from repro_torch.core.graphblas import GraphMatrix
    from repro_torch.core.words import to_uint
    from repro_torch.data import graphs as G
    from repro_torch.kernels.bmv import bmv, ref

    small = {"dot": (G.dot_graph(3000, 0.004, seed=SEED), 3000),
             "rmat": (G.rmat_graph(4096, 16, seed=SEED), 4096),
             "road": (G.road_graph(64), 4096)}
    cases = [(name, GraphMatrix.from_coo(r, c, n, n, t))
             for name, ((r, c), n) in small.items() for t in (4, 8, 16, 32)]
    cases.append(("rmat_scale21", full_g.transposed()))
    n_checks, bad = 0, []
    max_err = dict.fromkeys(KERNELS, 0)
    for name, g in cases:
        m = g.b2sr
        for dens in DENSITIES:
            x = g.pack(torch.as_tensor(rng.random(g.n_cols) < dens,
                                       device="cuda"))
            mask = g.pack_rows(torch.as_tensor(rng.random(g.n_rows) < 0.5,
                                               device="cuda"))
            for comp in (True, False):
                args, kw = kernel_args(m, x, mask, comp)
                for k in KERNELS:
                    got = getattr(bmv, k)(*args, **kw)
                    want = getattr(ref, k)(*args, **kw)
                    torch.cuda.synchronize()
                    err = int((to_uint(got) - to_uint(want)).abs().max())
                    max_err[k] = max(max_err[k], err)
                    n_checks += 1
                    if err:
                        bad.append([k, name, m.tile_dim, dens, comp])
    line = {"phase": "kernels", "ok": not bad, "checks": n_checks,
            "max_abs_err": max_err, "mismatches": bad[:10]}
    emit(line)
    if bad:
        fail("kernels", f"{len(bad)} kernel/plain mismatches")
    return max_err


def scipy_levels(rows, cols, n, sources):
    import scipy.sparse as sp
    from scipy.sparse.csgraph import shortest_path
    a = sp.csr_matrix((np.ones(len(rows)), (rows, cols)), shape=(n, n))
    d = shortest_path(a, directed=True, unweighted=True, indices=sources)
    return np.where(np.isinf(d), -1, d).astype(np.int32)


def phase_bfs(g, rows, cols, deg, sources):
    """The main path on b2sr_cuda, checked against csr and SciPy.

    Rate: Graph500's traversed edges per second, the undirected edges of
    the source's component over the traversal's wall time.
    """
    from repro_torch.algorithms import bfs
    from repro_torch.kernels.bmv import bmv

    bmv.bmv_bbb_push.launches = 0
    bmv.bmv_bbb_pull.launches = 0
    runs, wall = {}, {}
    for d in DIRECTIONS:
        for s in sources:
            runs["b2sr_cuda", d, s], wall["b2sr_cuda", d, s] = sync_time(
                lambda: bfs(g, s, direction=d))
    launches = {k: getattr(bmv, k).launches for k in KERNELS}
    if not all(launches.values()):
        fail("bfs", f"a kernel of the path never launched: {launches}")
    gc = g.with_backend("csr")
    for d in DIRECTIONS:
        for s in sources:
            runs["csr", d, s], wall["csr", d, s] = sync_time(
                lambda: bfs(gc, s, direction=d))
    want = scipy_levels(rows, cols, g.n_rows, sources)
    problems = []
    for d in DIRECTIONS:
        for i, s in enumerate(sources):
            a, b = runs["b2sr_cuda", d, s], runs["csr", d, s]
            lv = a.levels.cpu().numpy()
            if not np.array_equal(lv, b.levels.cpu().numpy()):
                problems.append(f"levels != csr ({d}, {s})")
            if (a.n_iterations, a.directions) != (b.n_iterations,
                                                  b.directions):
                problems.append(f"schedule != csr ({d}, {s})")
            if not np.array_equal(lv, want[i]):
                problems.append(f"levels != scipy ({d}, {s})")
    first = runs["b2sr_cuda", "auto", sources[0]]
    edges = {s: int(deg[want[i] >= 0].sum()) // 2
             for i, s in enumerate(sources)}
    emit({"phase": "bfs", "ok": not problems, "problems": problems[:10],
          "sources": sources, "launches": launches,
          "reached": [int((want[i] >= 0).sum()) for i in range(len(sources))],
          "traversed_edges": [edges[s] for s in sources],
          "n_iterations": {d: [runs["b2sr_cuda", d, s].n_iterations
                               for s in sources] for d in DIRECTIONS},
          "auto_directions": list(first.directions),
          "bfs_wall_s": {f"{be}/{d}": [wall[be, d, s] for s in sources]
                         for be in ("b2sr_cuda", "csr")
                         for d in DIRECTIONS},
          "median_gteps": {f"{be}/{d}": statistics.median(
              edges[s] / wall[be, d, s] / 1e9 for s in sources)
              for be in ("b2sr_cuda", "csr") for d in DIRECTIONS}})
    if problems:
        fail("bfs", "; ".join(problems[:5]))
    return runs["b2sr_cuda", "push", sources[0]], launches


def needed_bytes_ops(m, x, mask, kernel):
    """Bytes and lane operations the inputs need (data-dependent).

    Counted once: row pointers, x, mask and the output. Push reads the
    column index of every tile and the t words of each tile whose
    frontier word is non-zero. Pull needs only rows with an allowed lane,
    and in each such row only the tiles, in stored order, up to the one
    after which every allowed lane that any tile of the row can set is
    set (the early exit at one-tile granularity; the kernel stops at
    32-tile granularity, so it reads at least this). Operations: an AND
    and an OR per tile word read.
    """
    import torch
    from repro_torch.core.b2sr import tile_rows
    from repro_torch.core.words import lane_mask, unpack_bits

    tr = tile_rows(m)
    xw_nz = x[m.tile_col_idx.long()] != 0
    if kernel == "bmv_bbb_pull":
        n_rows = m.n_tile_rows
        pos = torch.arange(m.n_tiles, device=x.device) - \
            m.tile_row_ptr[tr].long()
        count = (m.tile_row_ptr[1:] - m.tile_row_ptr[:-1]).long()
        allowed = unpack_bits(~mask & lane_mask(m.tile_dim), m.tile_dim)
        walk = torch.zeros(n_rows, dtype=torch.long, device=x.device)
        for b in range(m.tile_dim):     # first tile of each row setting lane b
            hit = torch.nonzero(xw_nz & ((m.bit_tiles[:, b] & x[
                m.tile_col_idx.long()]) != 0)).flatten()
            first = torch.full((n_rows,), -1, dtype=torch.long,
                               device=x.device)
            first = first.scatter_reduce(0, tr[hit], pos[hit], "amin",
                                         include_self=False)
            # a lane no tile sets keeps the row scanning to its end
            need = torch.where(first >= 0, first + 1, count)
            walk = torch.maximum(walk, torch.where(allowed[:, b], need, 0))
        read = pos < walk[tr]
        n_col, n_tiles = int(read.sum()), int((read & xw_nz).sum())
    else:
        n_col, n_tiles = m.n_tiles, int(xw_nz.sum())
    r, c = m.n_tile_rows, m.n_tile_cols
    nbytes = 4 * ((r + 1) + n_col + n_tiles * m.tile_dim + c + r + r)
    ops = 2 * n_tiles * m.tile_dim
    return nbytes, ops


def phase_timing(g, levels, n_iterations, bfs_launches):
    """Per-launch times on the inputs of each iteration of one traversal."""
    import torch
    from repro_torch.core.descriptor import Descriptor
    from repro_torch.core.operands import BitVector
    from repro_torch.kernels.bmv import bmv, ref

    gt = g.transposed()
    m = gt.b2sr
    csr_t = gt.csr
    with warnings.catch_warnings():     # "sparse CSR support is in beta"
        warnings.simplefilter("ignore", UserWarning)
        spm = torch.sparse_csr_tensor(
            csr_t.row_ptr, csr_t.col_idx, csr_t.values,
            size=(csr_t.n_rows, csr_t.n_cols), check_invariants=False)
    gc = gt.with_backend("csr")
    rows = {k: [] for k in KERNELS}
    csr_row_ms = []
    for it in range(n_iterations):
        front = gt.pack((levels == it).to(torch.int32))
        visited = gt.pack_rows(((levels >= 0) & (levels <= it)).to(torch.int32))
        xf = BitVector.from_words(front, gt.n_cols, gt.tile_dim)
        vis = BitVector.from_words(visited, gt.n_rows, gt.tile_dim)
        x_dense = xf.unpack(torch.float32)
        lib_ms = event_ms(lambda: torch.mv(spm, x_dense))
        csr_row_ms.append(event_ms(lambda: gc.mxv(
            xf, desc=Descriptor(mask=vis, complement=True))))
        for k in KERNELS:
            args, kw = kernel_args(m, front, visited, True)
            nbytes, ops = needed_bytes_ops(m, front, visited, k)
            rows[k].append({
                "it": it,
                "ms": event_ms(lambda: getattr(bmv, k)(*args, **kw)),
                "plain_ms": event_ms(lambda: getattr(ref, k)(*args, **kw),
                                     reps=3),
                "library_ms": lib_ms,
                "bytes": nbytes, "ops": ops,
                "bound_ms": 1e3 * max(nbytes / HBM_BYTES_PER_S,
                                      ops / LANE_OPS_PER_S),
            })
    emit({"phase": "timing", "ok": True, "per_iteration": rows,
          "csr_row_ms": csr_row_ms,
          "graph": {"n": g.n_rows, "nnz": g.nnz, "n_tiles": m.n_tiles,
                    "n_tile_rows": m.n_tile_rows}})

    def mean(k, key):
        return statistics.fmean(r[key] for r in rows[k])

    table = []
    for k, where in KERNELS.items():
        bound_bytes = mean(k, "bytes") / HBM_BYTES_PER_S
        bound_ops = mean(k, "ops") / LANE_OPS_PER_S
        table.append({
            "name": k, "route": "cuda",
            "source": "src/repro_torch/kernels/bmv/bmv.cu",
            "replaces": where, "launches": bfs_launches[k],
            "ms": mean(k, "ms"), "plain_ms": mean(k, "plain_ms"),
            "bound_ms": mean(k, "bound_ms"),
            "bound_by": "bytes" if bound_bytes >= bound_ops else "operations",
            "library_ms": mean(k, "library_ms")})
    return table, statistics.fmean(csr_row_ms)


def phase_profile(g, source):
    """Device busy time of one BFS per direction (torch.profiler, CUPTI):
    kernel time by name, and the share of the wall time the card idled."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.algorithms import bfs

    out = {}
    for d in DIRECTIONS:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            _, wall = sync_time(lambda: bfs(g, source, direction=d))
        busy = {}
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                # drop the parameter list, keep the kernel and its functor
                name = e.name.replace("(anonymous namespace)::", "")
                name = name.split("(")[0][:120]
                busy[name] = (busy.get(name, 0.0)
                              + e.time_range.elapsed_us() / 1e3)
        total = sum(busy.values())
        out[d] = {"wall_ms": 1e3 * wall,
                  "device_busy_ms": total if busy else None,
                  "idle_share": 1 - total / (1e3 * wall) if busy else None,
                  "top": sorted(busy.items(), key=lambda kv: -kv[1])[:6]}
    emit({"phase": "profile", "ok": True, "source": source,
          "by_direction": out})


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script measures the "
              "port on a GPU and has no CPU mode", file=sys.stderr)
        return 1
    from repro_torch.core.graphblas import GraphMatrix
    from repro_torch.data.graphs import rmat_graph
    from repro_torch.kernels import common
    from repro_torch.kernels.bmv import bmv

    t0 = time.perf_counter()
    common.load_library(bmv.SOURCE)
    emit({"phase": "build", "ok": True,
          "seconds": time.perf_counter() - t0,
          "ptxas": [ln for ln in common.BUILD_LOG.get("bmv", "").splitlines()
                    if "registers" in ln or "spill" in ln]})

    rng = np.random.default_rng(SEED)
    n = 1 << SCALE
    t0 = time.perf_counter()
    rows, cols = rmat_graph(n, avg_degree=2 * EDGEFACTOR, seed=SEED)
    gen_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    g, build_s = sync_time(lambda: GraphMatrix.from_coo(
        rows, cols, n, n, TILE_DIM, backend="b2sr_cuda"))
    ptr = g.b2sr.tile_row_ptr
    emit({"phase": "graph", "ok": True, "n": n, "directed_edges": len(rows),
          "n_tiles": g.b2sr.n_tiles,
          "max_tiles_per_row": int((ptr[1:] - ptr[:-1]).max()),
          "generate_s": gen_s,
          "from_coo_s": build_s,
          "peak_device_bytes": torch.cuda.max_memory_allocated()})

    max_err = phase_kernels(g, rng)

    deg = np.bincount(rows, minlength=n)
    sources = [int(s) for s in np.random.default_rng(SEED + 1).choice(
        np.flatnonzero(deg), N_SOURCES, replace=False)]
    first, launches = phase_bfs(g, rows, cols, deg, sources)

    table, csr_ms = phase_timing(g, first.levels, first.n_iterations,
                                 launches)
    for row in table:
        row["max_abs_err"] = max_err[row["name"]]
        row["csr_row_ms"] = csr_ms
    phase_profile(g, sources[0])

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    emit({"kernels": table})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
