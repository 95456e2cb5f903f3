#!/usr/bin/env python3
"""Time variants of the ``pack_dense`` and ``pack_rows`` kernels on one GPU.

Run from the repository root:

    python3 tools/bitpack_variants.py            # [32768, 32768], t = 32
    python3 tools/bitpack_variants.py --side 8192
    python3 tools/bitpack_variants.py --kernel pack_rows
    python3 tools/bitpack_variants.py --kernel pack_rows \
        --baseline OTHER/bitpack.cu

Each variant is a copy of ``src/repro_torch/kernels/bitpack/bitpack.cu``
with one of its constants changed, written to ``build/bitpack_variants/``
and built with ``nvcc`` like the source itself. Every variant is checked
bit for bit against the plain version (``kernels/bitpack/ref.py``) first,
then timed twice: in order and in reverse.

``pack_dense`` (the default): the bytes of its row a lane reads
(``kPackRunBytes``). Checks: ``chip_smoke.py``'s [70, m] inputs of each
entry type at widths that take the vector and the scalar path, row- and
column-major, at t = 4 and 32. Timed (CUDA events, median of 15) on a
[side, side] uint8 0/1 matrix row- and column-major and on the same
entries as float32 (as they are, and with -0.0 for half the zeros).

``pack_rows``: the 32-row groups a warp walks (``kRowGroups`` 1, 2, 4,
8) and the 16-byte loads turned off (``kRowVectors`` 0), with
``--baseline`` another ``bitpack.cu`` (an earlier checkout's, whose
``pack_rows`` takes the same arguments) beside them in the same passes.
Checks: ``chip_smoke.py``'s pack_rows inputs (each entry type at D = 1,
7, 16, 33, 130, 70 rows, and offset views) at every t. Timed at t = 32
on [2,097,152, D] 0/1 entries, as the hidden layer of ``gnn_infer``
gives them at gcn-cora's widths (D = 16, bool and float32), and as bool
at D = 1 and 130: each launch's device time (torch.profiler, median of
15) and the wrapper's time (CUDA events around the call, median of 15).

Prints the card's name and power limit, each variant's registers (from
``ptxas -v``), the bounds and one JSON line of times.
"""

from __future__ import annotations

import argparse
import itertools
import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

SOURCE = ROOT / "src/repro_torch/kernels/bitpack/bitpack.cu"
#: variant name -> {constant: value}; "default" is the source as it is
VARIANTS = {
    "default": {},
    "run_64": {"kPackRunBytes": 64},
    "run_128": {"kPackRunBytes": 128},
    "run_256": {"kPackRunBytes": 256},
    "run_512": {"kPackRunBytes": 512},
}
ROWS_VARIANTS = {
    "default": {},
    "groups_1": {"kRowGroups": 1},
    "groups_2": {"kRowGroups": 2},
    "groups_4": {"kRowGroups": 4},
    "groups_8": {"kRowGroups": 8},
    "no_vectors": {"kRowVectors": 0},
}
ROWS_N = 2_097_152              # gnn_infer's hidden layer on R-MAT scale 21
ROWS_CASES = (("bool", 16), ("float32", 16), ("bool", 1), ("bool", 130))


def variant_source(changes) -> str:
    text = SOURCE.read_text()
    for name, value in changes.items():
        head = f"constexpr int {name} = "
        start = text.index(head) + len(head)
        end = text.index(";", start)
        text = text[:start] + str(value) + text[end:]
    return text


def registers(log: str, kernel: str):
    """Registers of the t = 32 pack_dense (``kernel`` "dense") or
    pack_rows ("rows") kernels, by entry code."""
    out, cur = {}, ""
    for line in log.splitlines():
        if "Compiling entry function" in line:
            cur = line.split("'")[1]
        elif "Used" in line:
            for e in range(3):
                if (f"pack_dense_kernelILi{e}ELi32E" if kernel == "dense"
                        else f"pack_rows_kernelILi{e}ELi32E") in cur:
                    out[e] = int(line.split("Used")[1].split()[0])
    return out


def build(variants, baseline=None):
    """Write and build each variant (and ``baseline`` as it is), one
    ``nvcc`` each, all at once; {name: source path}."""
    from repro_torch.kernels import common
    out_dir = ROOT / "build" / "bitpack_variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    paths = {}
    for name, changes in variants.items():
        path = out_dir / f"bitpack_{name}.cu"
        path.write_text(variant_source(changes))
        paths[name] = path
    if baseline is not None:
        paths["baseline"] = baseline
    with ThreadPoolExecutor(len(paths)) as pool:
        list(pool.map(common.load_library, paths.values()))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    return paths


def rows_main(baseline) -> int:
    """The ``--kernel pack_rows`` mode (see the module's docstring)."""
    import torch
    import chip_smoke as cs
    from repro_torch.kernels import common
    from repro_torch.kernels.bitpack import bitpack, ref

    paths = build(ROWS_VARIANTS, baseline)
    regs = {name: registers(common.BUILD_LOG.get(p.stem, ""), "rows")
            for name, p in paths.items()}
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED + 7)
    checks = list(cs.rows_inputs(gen))
    t = cs.TILE_DIM
    cases, bounds = {}, {}
    for dtype, d in ROWS_CASES:
        x = torch.rand((ROWS_N, d), generator=gen, device="cuda") < 0.5
        x = x.to(getattr(torch, dtype))
        key = f"{dtype}[{ROWS_N}, {d}]"
        cases[key] = (x, ref.pack_rows(x, t))
        bounds[key] = cs.bound_row(x.numel() * x.element_size()
                                   + 4 * cases[key][1].numel(),
                                   2 * x.numel())["bound_ms"]
    times = {name: {**{k: {"device_ms": [], "ms": []} for k in cases},
                    "ok": True} for name in paths}
    for order in (list(paths), list(reversed(paths))):
        for name in order:
            bitpack.SOURCE = paths[name]
            row = times[name]
            row["ok"] &= all(torch.equal(bitpack.pack_rows(x, tt),
                                         ref.pack_rows(x, tt))
                             for (_, x), tt in itertools.product(
                                 checks, (4, 8, 16, 32)))
            for key, (x, want) in cases.items():
                row["ok"] &= torch.equal(bitpack.pack_rows(x, t), want)
                row[key]["device_ms"].append(cs.device_ms(
                    lambda x=x: bitpack.pack_rows(x, t), "pack_rows_kernel"))
                row[key]["ms"].append(cs.event_ms(
                    lambda x=x: bitpack.pack_rows(x, t)))
    bitpack.SOURCE = SOURCE
    print(json.dumps({"kernel": "pack_rows", "t": t,
                      "variants": ROWS_VARIANTS,
                      "baseline": None if baseline is None else str(baseline),
                      "registers": regs, "bound_ms": bounds,
                      "times": times}))
    return 0 if all(r["ok"] for r in times.values()) else 1


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--side", type=int, default=32768)
    parser.add_argument("--kernel", choices=("pack_dense", "pack_rows"),
                        default="pack_dense")
    parser.add_argument("--baseline", type=Path, default=None,
                        help="with --kernel pack_rows: another bitpack.cu "
                             "whose pack_rows is timed beside")
    opts = parser.parse_args()
    side = opts.side
    import torch
    if not torch.cuda.is_available():
        print("bitpack_variants: CUDA is not available", file=sys.stderr)
        return 1
    if opts.kernel == "pack_rows":
        return rows_main(None if opts.baseline is None
                         else opts.baseline.resolve())
    import chip_smoke as cs
    from repro_torch.kernels import common
    from repro_torch.kernels.bitpack import bitpack, ref

    paths = build(VARIANTS)
    regs = {name: registers(common.BUILD_LOG.get(p.stem, ""), "dense")
            for name, p in paths.items()}

    gen = torch.Generator(device="cuda").manual_seed(cs.SEED + 6)
    checks = list(cs.pack_inputs(gen))
    x = torch.randint(0, 2, (side, side), dtype=torch.uint8, generator=gen,
                      device="cuda")
    xf = x.float()
    # the same entries with -0.0 for half the zeros, as chip_smoke.py's
    xz = xf.clone()
    xz[(x == 0) & (torch.rand(x.shape, generator=gen, device="cuda")
                   < 0.5)] = -0.0
    t = cs.TILE_DIM
    r_c = -(-side // t)
    out_bytes = 4 * r_c * r_c * t
    bounds = {"uint8": cs.bound_row(x.numel() + out_bytes, 2 * x.numel()),
              "float32": cs.bound_row(4 * x.numel() + out_bytes,
                                      2 * x.numel())}
    wants = [ref.pack_dense(x, t), ref.pack_dense(x, t, True)]
    cases = {"uint8_ms": (x, False), "uint8_col_major_ms": (x, True),
             "float32_ms": (xf, False), "float32_neg_zero_ms": (xz, False)}
    times = {name: {**{k: [] for k in cases}, "ok": True} for name in paths}
    for order in (list(paths), list(reversed(paths))):
        for name in order:
            bitpack.SOURCE = paths[name]
            row = times[name]
            row["ok"] &= all(
                torch.equal(bitpack.pack_dense(c, tt, cm),
                            ref.pack_dense(c, tt, cm))
                for (_, c), tt, cm in itertools.product(
                    checks, (4, 32), (False, True)))
            row["ok"] &= torch.equal(bitpack.pack_dense(x, t), wants[0])
            row["ok"] &= torch.equal(bitpack.pack_dense(x, t, True),
                                     wants[1])
            row["ok"] &= torch.equal(bitpack.pack_dense(xf, t), wants[0])
            row["ok"] &= torch.equal(bitpack.pack_dense(xz, t), wants[0])
            for key, (inp, cm) in cases.items():
                row[key].append(cs.event_ms(
                    lambda inp=inp, cm=cm: bitpack.pack_dense(inp, t, cm)))
    bitpack.SOURCE = SOURCE
    print(json.dumps({"side": side, "variants": VARIANTS, "registers": regs,
                      "bounds": bounds, "times": times}))
    return 0 if all(r["ok"] for r in times.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
