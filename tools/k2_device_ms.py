"""K2's device time a call, by torch.profiler, for the ``adflow_torch`` of
one checkout: to hold two versions of the kernel against each other on one
card with one measure.

    python tools/k2_device_ms.py TREE

TREE is a checkout of this repository (``.`` for this one); its
``adflow_torch`` is imported, so each version runs in a process of its own.
Runs the default ANK solve of the 256x64x64 Euler wing (M 0.84, alpha 3.06,
5 steps, as ``chip_smoke.py`` [12] does), then calls that tree's
``cuda_inviscid.fused_inviscid_residual`` N_CALLS times under
torch.profiler, at the solve's final state and on ``sample_operands``. For
each it prints the device time a call of the kernels whose names hold
``inviscid`` (every pass of the kernel) and of all device operations in the
calls, over the calls the profile holds, after the card's name and power
limit. Exits with 1 without a card.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

FULL_DIMS = (256, 64, 64)
ANK_STEPS = 5
N_CALLS = 20
WARM_S = 0.2        # seconds of calls before the profile, to raise clocks


def device_ms(call):
    """(kernel ms, all-device ms, calls seen) a call of ``call()`` under the
    profiler; the kernel's are the device operations whose names hold
    ``inviscid``. A call is counted where the profile holds its kernel: the
    profile may lose records, so the times are per call seen, and the
    count is printed beside them."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    t0 = time.perf_counter()
    while time.perf_counter() - t0 < WARM_S:
        call()
        torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(N_CALLS):
            call()
        torch.cuda.synchronize()
    rows = [(e.key, e.self_device_time_total, e.count)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    # each pass of the kernel runs once a call
    seen = max(c for key, _, c in rows if "inviscid" in key)
    kernel = sum(t for key, t, _ in rows if "inviscid" in key)
    total = sum(t for _, t, _ in rows)
    return kernel / 1e3 / seen, total / 1e3 / seen, seen


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("tree")
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.tree))
    import torch
    if not torch.cuda.is_available():
        print("k2_device_ms: no CUDA device", file=sys.stderr)
        return 1
    from adflow_torch.api.solver import ADFLOW
    from adflow_torch.core.refstate import AeroProblem
    from adflow_torch.meshgen.analytic import wing_omesh
    from adflow_torch.ops import cuda_inviscid
    from adflow_torch.physics.thermo import pressure
    from adflow_torch.utils.timing import card_line

    print(card_line())
    print(f"K2 of {os.path.dirname(cuda_inviscid.__file__)}")
    solver = ADFLOW(options={"equationType": "euler", "nCycles": ANK_STEPS,
                             "printIterations": False,
                             "printTiming": False},
                    mesh=wing_omesh(ni=FULL_DIMS[0], nj=FULL_DIMS[1],
                                     nk=FULL_DIMS[2]))
    aero = AeroProblem(name="m6e", mach=0.84, alpha=3.06)
    solver.setAeroProblem(aero)
    solver(aero)
    w = solver._filled_w()[0]
    m, cfg = solver.metrics_list[0], solver.cfg
    states = {
        "post-solve": ([w, pressure(w), m.siE, m.sjE, m.skE,
                        *solver.topo.blocks[0].por],
                       (cfg.vis2, cfg.vis4, cfg.diss_exponent)),
        "sample": cuda_inviscid.sample_operands(FULL_DIMS, "cuda:0"),
    }
    for label, (tensors, consts) in states.items():
        kernel, total, seen = device_ms(
            lambda: cuda_inviscid.fused_inviscid_residual(*tensors, *consts))
        print(f"  {label} {'x'.join(map(str, FULL_DIMS))}: K2 kernels "
              f"{kernel:.4f} ms, all device operations {total:.4f} ms a "
              f"call ({seen} of {N_CALLS} calls in the profile)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
