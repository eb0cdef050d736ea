"""The RK path's cycle breakdown for the ``adflow_torch`` of one checkout: to
hold two versions of the RK path against each other on one card.

    python tools/rk_cycle_profile.py TREE

TREE is a checkout of this repository (``.`` for this one); its
``chip_smoke.py`` and ``adflow_torch`` are imported, so each version runs in
a process of its own. Runs that tree's ``chip_smoke.py`` phases [5] and
[8]: 50 RK cycles of the RANS-SA 256x64x64 wing through ``ADFLOW``, then
one cycle's pieces timed alone (CUDA events) and two cycles under
torch.profiler: wall ms, device busy ms, device ops, idle share and K1's
device ms a launch, after the card's name and power limit. Exits with 1
without a card.
"""

from __future__ import annotations

import argparse
import os
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("tree")
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.tree))
    import torch
    if not torch.cuda.is_available():
        print("rk_cycle_profile: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke
    from adflow_torch.utils.timing import card_line

    print(card_line())
    tree = os.path.dirname(os.path.abspath(chip_smoke.__file__))
    print(f"RK path of {tree}")
    solver, _ = chip_smoke.main_path()
    k1_ms = chip_smoke.cycle_breakdown(solver)
    print(f"K1 device ms a launch in two cycles: {k1_ms:.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
