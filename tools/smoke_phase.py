#!/usr/bin/env python3
"""Run phases of ``chip_smoke.py`` alone on one GPU: a quicker check than
the whole script, or two checkouts compared in one call.

Run from the repository root:

    python3 tools/smoke_phase.py spmd                  # this checkout
    python3 tools/smoke_phase.py lm --root OTHER       # another checkout

Only the phases that build their own inputs run this way (``lm``,
``din``, ``spmd``); the others take the R-MAT graph that the script's
``main`` builds. Prints the card's name and power limit, each phase's
JSON lines as the script prints them, and each phase's wall; exits 1
when a phase fails.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

PHASES = ("lm", "din", "spmd")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("phases", nargs="+", choices=PHASES)
    ap.add_argument("--root", default=str(Path(__file__).resolve()
                                          .parents[1]),
                    help="the checkout whose chip_smoke.py runs")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("smoke_phase: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(args.root).resolve()))
    import chip_smoke

    print(chip_smoke.card_line(), chip_smoke.__file__, flush=True)
    for name in args.phases:
        t0 = time.perf_counter()
        try:
            getattr(chip_smoke, "phase_" + name)()
        except SystemExit as e:
            print(f"{name}: failed ({e.code})", flush=True)
            return 1
        finally:
            print(f"{name} wall {time.perf_counter() - t0:.3f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
