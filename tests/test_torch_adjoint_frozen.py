"""The port's adjoint on the 16x12 RANS-SA plate with ``frozenTurbulence``
on, against the JAX package, float64 on the CPU, at the seeded perturbed
state of tests/torch_pairs.py: psi (zero on the turbulence rows) and the
``evalFunctionsSens`` totals of cd after a fixed 20 GMRES iterations in
both packages, to 1e-9; the JAX totals from its adjoint functions under
``jax.jit`` (``torch_pairs.jitted_sens_pair``). The converged totals,
through the JAX package's own ``evalFunctionsSens``, are a slow test: that
takes minutes on the CPU. Also the plate's function gradients with
respect to w, x and the design variables, to 1e-10.
"""

import numpy as np
import pytest

from tests.torch_pairs import (
    FIXED_20, check_function_gradients, check_sens, jitted_sens_pair,
    sens_pair)


@pytest.fixture(scope="module")
def frozen():
    return jitted_sens_pair("rans_plate", "cd", frozenTurbulence=True,
                            **FIXED_20)


def test_frozen_turbulence_adjoint_matches_jax(frozen):
    check_sens(frozen, "cd", converged=False)
    ts = frozen[1]
    psi = ts._psi_cache[("fp", "cd")].numpy().reshape(-1, 6)
    assert (psi[:, 5] == 0.0).all() and np.abs(psi[:, :5]).max() > 0.0
    assert ts.adjoint_info.iters == 20


def test_rans_function_gradients_match_jax(frozen):
    check_function_gradients(*frozen[:2], ["cd", "cl"], jit=True)


@pytest.mark.slow
def test_converged_rans_adjoint_matches_jax():
    """The converged adjoint of the plate (JAX: minutes on the CPU)."""
    check_sens(sens_pair("rans_plate", ["cd"], frozenTurbulence=True),
               "cd", converged=True)
