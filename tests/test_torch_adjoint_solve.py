"""The port's adjoint solve on the 16x8x8 Euler wing against the JAX
package, float64 on the CPU, at the seeded perturbed state of
tests/torch_pairs.py.

- psi and the ``evalFunctionsSens`` totals of cl, with the adjoint GMRES
  converged in both packages, to 1e-9;
- the residual's vjp and the function gradients with respect to w, x and
  the design variables, to 1e-10;
- ``solveAdjointForRHS`` and ``solveDirectForRHS`` to 1e-9, with the
  reference's quirks: GMRES runs max(1, adjointMaxIter //
  adjointSubspaceSize) cycles (12 // 5: two cycles of 5, not 12
  iterations), and the direct solve's PC takes kappa 0.25 whatever
  ``linePCKappa`` says.

The JAX package's ``evalFunctionsSens`` is the cost of this file (about
80 s on one worker), so it runs once, in the module's fixture.
"""

import numpy as np
import pytest

from tests.torch_pairs import (
    SENS_TOL, check_function_gradients, check_residual_vjp, check_sens,
    rel, sens_pair)


@pytest.fixture(scope="module")
def euler():
    return sens_pair("euler_wing", ["cl"])


def test_euler_cl_adjoint_matches_jax(euler):
    want, got = check_sens(euler, "cl", converged=True)
    # the totals the optimizer reads are not trivially zero
    assert abs(want["alpha"]) > 0.1 and abs(want["mach"]) > 0.01
    assert np.abs(want["xv"]).max() > 0.1


def test_euler_residual_vjp_matches_jax(euler):
    check_residual_vjp(*euler[:2])


def test_euler_function_gradients_match_jax(euler):
    check_function_gradients(*euler[:2], ["cl", "cd"])


@pytest.mark.parametrize("method", ["solveAdjointForRHS",
                                    "solveDirectForRHS"])
def test_rhs_solves_match_jax(euler, method):
    js, ts = euler[:2]
    opts = {"adjointSubspaceSize": 5, "adjointMaxIter": 12,
            "linePCKappa": 1.0}
    for k, v in opts.items():
        js.setOption(k, v)
        ts.setOption(k, v)
    rhs = np.random.default_rng(4).standard_normal(ts.getStates().shape)
    want = getattr(js, method)(rhs, relTol=1e-14)
    got = getattr(ts, method)(rhs, relTol=1e-14)
    assert isinstance(got, np.ndarray) and got.shape == rhs.shape
    assert rel(want, got) < SENS_TOL
    # ten iterations from zero moved the solution
    assert np.abs(got).max() > 0.0
