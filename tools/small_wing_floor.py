"""The f32 floor of the default ANK solve of the 16x8x8 Euler wing on the
card: the residual over the free-stream one after each step, from alpha
2 (chip_smoke.py [29] stops each of its solveCL solves at an
L2Convergence above this floor):

    python tools/small_wing_floor.py [STEPS]

Run from the repository's root on the machine with the card.
"""

from __future__ import annotations

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402

from adflow_torch.api.solver import ADFLOW  # noqa: E402
from adflow_torch.core.refstate import AeroProblem  # noqa: E402
from adflow_torch.meshgen.analytic import wing_omesh  # noqa: E402
from benchmark.harness import power_limit  # noqa: E402


def main(steps: int = 30) -> None:
    print(f"{torch.cuda.get_device_name(0)}, {power_limit()}")
    solver = ADFLOW(options={"equationType": "euler", "nCycles": steps,
                             "L2Convergence": 1e-12,
                             "printIterations": False,
                             "printTiming": False},
                    mesh=wing_omesh(ni=16, nj=8, nk=8))
    ap = AeroProblem(name="m6e", mach=0.84, alpha=2.0, evalFuncs=["cl"])
    t0 = time.perf_counter()
    solver(ap)
    torch.cuda.synchronize()
    info = solver.solve_info
    drop = info.history[:, 0] / info.total_r0
    print(f"16x8x8 Euler wing, {solver.dtype}, default ANK from alpha 2: "
          f"{len(info.steps)} steps in {time.perf_counter() - t0:.3f} s")
    print("R/R0 by step: " + " ".join(f"{v:.3e}" for v in drop))
    print(f"cl {solver.evalFunctions(ap, {})['m6e_cl']!r}")


if __name__ == "__main__":
    main(*(int(a) for a in sys.argv[1:]))
