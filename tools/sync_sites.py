#!/usr/bin/env python3
"""The synchronising operations of one unit of a cell of the benchmark, by
the program's site that made each:

    python3 tools/sync_sites.py --workload <cell> [--seed N]

from the root of a checkout, on a machine with a CUDA card. It builds the
cell as the benchmark does (the mesh, ``ADFLOW``, the seeded start, the
warm-up units), then runs one more unit under
``torch.cuda.set_sync_debug_mode("warn")`` and prints each synchronising
operation (a copy to the host, a blocking copy from pageable memory, a
synchronize) by the innermost frame of ``adflow_torch`` or ``benchmark``
that made it, and how many came from inside an RK iteration
(``smoothers.rk_iteration``, ``multigrid._forced_rk_iteration``) or the
capture or replay of its CUDA graph (``solvers/rk_graph.py``): none may,
since a capture fails on a synchronising call."""

from __future__ import annotations

import argparse
import collections
import sys
import traceback
import warnings
from pathlib import Path
from types import SimpleNamespace

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from benchmark import harness  # noqa: E402

ITERATION = ("rk_iteration", "_forced_rk_iteration", "_capture", "__call__")


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, default=8300000001)
    args = ap.parse_args(argv)
    import torch

    cell = harness.find_cell(harness.load_benchmark(), args.workload)
    driver = harness.driver_module(cell.traffic["driver"])
    ctx = SimpleNamespace(cell=cell, seed=args.seed, seconds=1.0,
                          trace=False, device="cuda:0", cuda=True,
                          mesh_dims=None, expect_launches=True, profile=None)
    st = driver.setup(ctx)
    torch.cuda.synchronize()
    sites, inside = collections.Counter(), collections.Counter()

    def record(message, category, filename, lineno, file=None, line=None):
        mine = [f for f in traceback.extract_stack()[:-1]
                if "/adflow_torch/" in f.filename
                or "/benchmark/" in f.filename]
        if not mine:
            sites["(outside the program)"] += 1
            return
        f = mine[-1]
        key = (f"{Path(f.filename).relative_to(ROOT)}:{f.lineno} "
               f"{f.name}")
        sites[key] += 1
        if any(fr.name in ITERATION and "/solvers/" in fr.filename
               for fr in mine):
            inside[key] += 1

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = record
        torch.cuda.set_sync_debug_mode("warn")
        try:
            rec = driver.unit(ctx, st, 0)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    print(f"{args.workload}: {driver.describe(rec)}")
    print(f"  synchronising operations by site ({sum(sites.values())}):")
    for key, n in sites.most_common():
        print(f"    {n:5d}  {key}")
    print(f"  inside an RK iteration, its capture or its replay: "
          f"{sum(inside.values())} {dict(inside)}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
