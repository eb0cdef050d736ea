"""The measured errors of the physics options' CPU parity with the JAX
package (float64), the comparisons of tests/test_torch_sst.py,
_sa_variants.py, _wallfn.py, _ale.py and _lowspeed.py printed rather than
asserted:

    python tools/physics_parity.py

Needs the JAX package's environment (run from the repository's root, on
the CPU). For each case at the seeded perturbed free stream of
tests/torch_pairs.py: the block residual's largest difference over the
flux scale, the relative errors of the whole residual's jvp and vjp, and
for the wall functions the ghost fill's largest difference over the
largest entry.
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402

import adflow_tpu.physics.sst  # noqa: E402,F401  (before any jax.jit)
from tests.torch_pairs import (  # noqa: E402
    block_residual_pair, check_flat_derivatives, flux_scale, variant_pair)

MOTION = dict(rotRate=(0.0, 0.0, 30.0), rotCenter=(0.25, 0.1, 0.0),
              machGrid=0.1)
CASES = (
    ("SST, RANS wing", "rans_wing", None, {"turbulenceModel": "SST"}),
    ("SA variants together, RANS wing", "rans_wing", None,
     {"useRotationSA": True, "useQCR": True, "turbulenceModel": "SA-Edwards",
      "turbulenceOrder": "second order"}),
    ("grid motion, Euler wing", "euler_wing", MOTION, {}),
    ("grid motion, RANS plate", "rans_plate", {"machGrid": 0.2}, {}),
    ("low-speed preconditioner, Euler wing M 0.05", "euler_wing",
     {"mach": 0.05}, {"lowSpeedPreconditioner": True}),
    ("wall functions, RANS plate", "rans_plate", None,
     {"useWallFunctions": True}),
)


def main():
    for label, case, ap_changes, options in CASES:
        pair = variant_pair(case, ap_changes, **options)
        want, got = block_residual_pair(pair.js, pair.ts, pair.wj, pair.wt)
        res = np.abs(want - got).max() / flux_scale(
            pair.wj[0], pair.js.metrics_list[0])
        fill = (np.abs(np.asarray(pair.wj[0]) - pair.wt[0].numpy()).max()
                / np.abs(np.asarray(pair.wj[0])).max())
        jvp, vjp = check_flat_derivatives(pair, tol=1.0)
        print(f"{label}: residual {res:.2e} of the flux scale, ghost fill "
              f"{fill:.2e} of the largest entry, jvp {jvp:.2e}, vjp "
              f"{vjp:.2e}", flush=True)


if __name__ == "__main__":
    main()
