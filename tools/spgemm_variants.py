#!/usr/bin/env python3
"""Time the row lists and launch shapes of the ``spgemm_bbb`` kernel
(boolean SpGEMM) on one GPU.

Run from the repository root:

    python3 tools/spgemm_variants.py            # R-MAT scale 16, road 2048
    python3 tools/spgemm_variants.py --scale 12 --side 256
    python3 tools/spgemm_variants.py --public   # the public call alone

The products of ``chip_smoke.py``'s ``spgemm`` and ``khop`` phases, A²
and A²⟨¬A⟩ of the Graph500 R-MAT graph and one hop A²⟨¬A⟩ of the road
grid (t = 32), and two more A²: a mid-degree R-MAT graph (average degree
8) and the road grid with :data:`HUBS` vertices of :data:`HUB_OUT` random
out-edges each (a few long tile-rows among short ones), go through
``spgemm._spgemm_bbb`` with each setting of :data:`CONFIGS`: the pairs
that make a tile-row heavy, the threads a block and the most slots a
round for heavy and for light rows; ``one_list`` is the rule the wrapper
had before the lists, every row in one list and shape by A's mean row
length (here with the heavy list's order, most pairs first). Every setting must give the default's C bit for bit, and the
default the plain version's. Each is timed (CUDA events, median of 3; each
launch apart, and the shape the launcher took) in order and in reverse.
Prints the card's name and power limit, each input's work counts and
rows a list, and one JSON line of times.

``--public`` times ``spgemm.spgemm_bbb`` on the three products of the
phases through its public call alone (CUDA events, three medians of 15),
so that a copy of this file in another version of the port (its
``tools/``) times that version on the same inputs.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

#: hub vertices of the road grid with hubs, and their out-edges
HUBS, HUB_OUT = 8, 4096
#: setting name -> keyword arguments of ``spgemm._spgemm_bbb``
#: (``one_list`` is filled in per input)
CONFIGS = {
    "default": {},
    "heavy_256": {"heavy": 256},
    "heavy_4096": {"heavy": 4096},
    "heavy_16384": {"heavy": 16384},
    "all_heavy": {"heavy": 0},
    "all_light": {"heavy": "NEVER"},
    "one_list": None,
    "light_slots_16": {"slots": (1024, 16)},
    "light_slots_256": {"slots": (1024, 256)},
    "heavy_512_threads": {"threads": (512, 32)},
}


def config_args(name: str, a, spgemm) -> dict:
    """``_spgemm_bbb``'s keyword arguments of setting ``name`` for A."""
    if name == "one_list":     # before the lists: one shape by the mean
        if spgemm.window_by_warps(a):
            return {"heavy": 0}
        return {"heavy": spgemm.NEVER,
                "slots": (spgemm.SLOTS, spgemm.SLOTS)}
    return {k: spgemm.NEVER if v == "NEVER" else v
            for k, v in CONFIGS[name].items()}


def road_with_hubs(side: int, seed: int):
    """The road grid of ``side`` with :data:`HUBS` vertices given
    :data:`HUB_OUT` directed edges each to random vertices."""
    import numpy as np
    from repro_torch.data.graphs import road_graph
    r, c = road_graph(side)
    n = side * side
    rng = np.random.default_rng(seed)
    hub = rng.choice(n, HUBS, replace=False)
    return (np.concatenate([r, np.repeat(hub, HUB_OUT)]),
            np.concatenate([c, rng.integers(0, n, HUBS * HUB_OUT)]), n)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--scale", type=int, default=16)
    parser.add_argument("--side", type=int, default=2048)
    parser.add_argument("--public", action="store_true",
                        help="time the public call alone")
    args = parser.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("spgemm_variants: CUDA is not available", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch.core.b2sr import coo_to_b2sr
    from repro_torch.data.graphs import rmat_graph, road_graph
    from repro_torch.kernels import common
    from repro_torch.kernels.spgemm import ref, spgemm

    common.load_library(spgemm.SOURCE)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    n = 1 << args.scale
    rows, cols = rmat_graph(n, avg_degree=2 * cs.EDGEFACTOR, seed=cs.SEED)
    rmat = coo_to_b2sr(rows, cols, n, n, cs.TILE_DIM, "cuda")
    n_road = args.side * args.side
    rows, cols = road_graph(args.side)
    road = coo_to_b2sr(rows, cols, n_road, n_road, cs.TILE_DIM, "cuda")
    del rows, cols
    inputs = {"rmat_A2": (rmat, None, False),
              "rmat_A2_not_A": (rmat, rmat, True),
              "road_hop": (road, road, True)}
    if args.public:
        times = {key: [cs.event_ms(lambda: spgemm.spgemm_bbb(
            a, a, mk, complement=comp)) for _ in range(3)]
            for key, (a, mk, comp) in inputs.items()}
        print(json.dumps({"scale": args.scale, "side": args.side,
                          "public": True, "times": times}))
        return 0
    rows, cols = rmat_graph(n, avg_degree=8, seed=cs.SEED)
    inputs["rmat_deg8_A2"] = (coo_to_b2sr(rows, cols, n, n, cs.TILE_DIM,
                                          "cuda"), None, False)
    rows, cols, n_hub = road_with_hubs(args.side, cs.SEED)
    inputs["road_hubs_A2"] = (coo_to_b2sr(rows, cols, n_hub, n_hub,
                                          cs.TILE_DIM, "cuda"), None, False)
    del rows, cols
    info, want = {}, {}
    for key, (a, mk, comp) in inputs.items():
        events = []
        want[key] = spgemm._spgemm_bbb(a, a, mk, comp, events=events)
        plain = ref.spgemm_bbb(a, a, mk, complement=comp)
        ptr = a.tile_row_ptr.long()
        info[key] = {"window_by_warps": spgemm.window_by_warps(a),
                     "max_tiles_a_row": int((ptr[1:] - ptr[:-1]).max()),
                     "lists": [e[0] for e in events],
                     "c_tiles": want[key].n_tiles,
                     "plain_equal": cs.b2sr_mismatch(want[key], plain) == 0,
                     **cs.spgemm_work(a, a)}
        del plain
    print(json.dumps(info))

    times = {key: {name: {"ms": []} for name in CONFIGS} for key in inputs}
    used, ok = {}, {key: True for key in inputs}
    for rev in (False, True):
        for key, (a, mk, comp) in inputs.items():
            for name in (list(CONFIGS)[::-1] if rev else CONFIGS):
                kw = config_args(name, a, spgemm)
                got = spgemm._spgemm_bbb(a, a, mk, comp, **kw)
                ok[key] &= cs.b2sr_mismatch(got, want[key]) == 0
                del got
                row = times[key][name]
                row["ms"].append(cs.event_ms(
                    lambda: spgemm._spgemm_bbb(a, a, mk, comp, **kw),
                    reps=3))
                passes = {}
                for _ in range(3):
                    events = []
                    spgemm._spgemm_bbb(a, a, mk, comp, events=events, **kw)
                    cs.sync()
                    for pname, start, end, shape in events:
                        passes.setdefault(pname, []).append(
                            start.elapsed_time(end))
                        used[f"{key}/{name}/{pname}"] = list(shape)
                for pname, v in passes.items():
                    row.setdefault(f"{pname}_ms", []).append(
                        statistics.median(v))
    print(json.dumps({"scale": args.scale, "side": args.side,
                      "ok": {**ok, **{k: v["plain_equal"]
                                      for k, v in info.items()}},
                      "shapes_used": used, "times": times}))
    return 0 if all(ok.values()) and all(
        v["plain_equal"] for v in info.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
