"""One ANK step and one NK step of the port against the JAX package.

In float64 on the CPU, from the same seeded perturbed state, the same line-PC
data (built by the JAX package and carried across with
``interop.line_pc_from_numpy``) and the same CFL, each step returns the same
stats vector (7 entries for ANK, 5 for NK, newton.py:422-426,485-487) and
the same new state, to 1e-10 relative. Here: the coupled ANK step on the
Euler wing and on the RANS plate, and the NK step; the segregated and
approximate ANK steps are in tests/test_torch_ank_variants.py. The port's
step also reports how many exact residual evaluations it made: one for the
residual, one per GMRES matvec, the merits and one for the new residual.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adflow_torch.solvers import newton
from adflow_tpu.solvers import newton as jax_newton
from tests.torch_pairs import (
    SHORT, STEP_TOL, check_ank_step, check_stats, newton_pair, pc_pair, rel)


@pytest.fixture(scope="module")
def euler():
    return newton_pair("euler_wing")


@pytest.fixture(scope="module")
def rans():
    return newton_pair("rans_plate")


@pytest.mark.parametrize("case,options", [("euler", {}), ("rans", SHORT)])
def test_coupled_ank_step_matches_jax(request, case, options):
    res = check_ank_step(request.getfixturevalue(case), "coupled", options)
    # residual, one per matvec, three merits, new residual
    assert res.res_evals == 1 + res.krylov_matvecs + 3 + 1


def test_nk_step_matches_jax(euler):
    js, ts, jf, tf, w0 = euler
    pj, pt = pc_pair(jf, w0, 1e6, js)
    wj, sj = jax_newton.make_nk_step(jf, js.options)(
        jnp.asarray(w0), jnp.asarray(0.1), pj)
    res = newton.make_nk_step(tf, ts.options)(torch.from_numpy(w0), 0.1, pt)
    assert res.stats.shape == (5,)
    check_stats(sj, res.stats.numpy())
    assert rel(wj, res.w.numpy()) < STEP_TOL
    # residual, matvecs, the line search's five merits, new residual
    assert res.res_evals == 1 + res.krylov_matvecs + 5 + 1


def test_physicality_alpha_matches_jax(rans):
    _, _, jf, tf, w0 = rans
    d = np.random.default_rng(9).standard_normal(w0.shape) * np.abs(w0)
    want = jax_newton.physicality_alpha(jnp.asarray(w0), jnp.asarray(d),
                                        jf.packer)
    got = newton.physicality_alpha(torch.from_numpy(w0), torch.from_numpy(d),
                                   tf.packer)
    assert float(want) < 1.0
    assert abs(float(want) - float(got)) <= 1e-14
