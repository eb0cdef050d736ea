"""The segregated and approximate ANK steps of the port against the JAX
package, on the RANS plate (the setup and tolerance of
tests/test_torch_newton.py): the segregated step (the Krylov system on the
mean-flow rows, then the turbulence at the new mean flow) with
``ANKUseTurbDADI`` True (line-solve subiterations) and False (a small
turbulence Krylov solve), and the approximate step, whose matvecs linearize
the first-order residual twin.
"""

import pytest

from tests.torch_pairs import SHORT, check_ank_step, newton_pair


@pytest.fixture(scope="module")
def rans():
    return newton_pair("rans_plate")


@pytest.mark.parametrize("turb_dadi", [True, False])
def test_segregated_ank_step_matches_jax(rans, turb_dadi):
    check_ank_step(rans, "segregated", dict(SHORT, ANKUseTurbDADI=turb_dadi))


def test_approx_ank_step_matches_jax(rans):
    res = check_ank_step(rans, "approx", SHORT)
    # the matvecs linearize the first-order twin, not the residual
    assert res.res_evals == 1 + 3 + 1
