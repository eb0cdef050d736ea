"""The port's adjoint on the 16x12 RANS-SA plate against the JAX package,
float64 on the CPU, at the seeded perturbed state of tests/torch_pairs.py,
with ``frozenTurbulence`` off (tests/test_torch_adjoint_frozen.py has it
on).

- psi and the ``evalFunctionsSens`` totals of cd after a fixed 20 GMRES
  iterations in both packages (one cycle of 20 with a relative tolerance
  neither reaches), to 1e-9: the same Krylov iterates from the same
  operator and PC. The totals include reynolds and T, whose chains run
  through the viscosity. The JAX totals come from its adjoint functions
  under ``jax.jit`` (``torch_pairs.jitted_sens_pair``);
- the residual's vjp with respect to w, x and the design variables, to
  1e-10 (the function gradients are in test_torch_adjoint_frozen.py, to
  spread the JAX compile time over two files).
"""

import pytest

from tests.torch_pairs import (
    FIXED_20, check_residual_vjp, check_sens, jitted_sens_pair)


@pytest.fixture(scope="module")
def plate():
    return jitted_sens_pair("rans_plate", "cd", **FIXED_20)


def test_rans_cd_adjoint_matches_jax(plate):
    want, got = check_sens(plate, "cd", converged=False)
    assert plate[1].adjoint_info.iters == 20
    assert abs(want["reynolds"]) > 0.0 and abs(want["T"]) > 0.0


def test_rans_residual_vjp_matches_jax(plate):
    want = check_residual_vjp(*plate[:2], jit=True)
    # the viscosity chains reach the residual
    assert abs(float(want[2]["reynolds"])) > 0.0
    assert abs(float(want[2]["T"])) > 0.0
