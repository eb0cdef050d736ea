#!/usr/bin/env python3
"""The readings that set a cell's correctness limits, on the card:

    python3 benchmark/control.py --workload <cell> --seeds 1 2 3 \\
        [--controls bfloat16 tf32] [--seconds 1] [--out FILE]

For each seed, one run of the cell (set-up, a short window of whole units,
the check) gives the program's readings against the float64 reference;
with ``--controls``, the reference computed in each lower precision and
put in the program's place gives the control's readings at the same
states. One JSON line a seed goes to standard output and to ``--out``.
The benchmark's own runs do not run this."""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[0] = str(ROOT)

from benchmark import harness  # noqa: E402


def main(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--controls", nargs="*", default=())
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    cell = harness.find_cell(harness.load_benchmark(), args.workload)
    # the readings need no warm-up unit
    cell.traffic["warmup_units"] = 0
    harness.require_cards(int(cell.entry.get("chips", 1)))
    out = open(args.out, "a") if args.out else None
    try:
        for i, seed in enumerate(args.seeds):
            result, _ = harness.run_cell(
                cell, seed, args.seconds, False,
                T_START if i == 0 else time.perf_counter(),
                controls=tuple(args.controls))
            line = json.dumps({"workload": args.workload, "seed": seed,
                               "correct": result["correct"],
                               "failed": result["failed"],
                               "checks": result["checks"],
                               "controls": result.get("controls", {})})
            print(line, flush=True)
            if out:
                out.write(line + "\n")
                out.flush()
    finally:
        if out:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
