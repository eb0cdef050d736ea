"""The linear-solver pieces of the ANK/NK slice against the JAX package.

In float64 on the CPU, from the same seeded numpy inputs:
- ``gmres`` (solvers/krylov.py) on a nonsymmetric system with a diagonal
  preconditioner: the same x, iteration count and residual estimate to
  1e-12, for one and two restarts;
- the line solves: ``solve_small``, ``block_tridiag_solve`` and
  ``tridiag_solve`` (solvers/dadi.py);
- the exact flux Jacobians of the line PC;
- ``build_line_pc`` + ``line_pc_apply`` on the filled 16x8x8 Euler wing and
  on a small RANS plate, applied to random vectors, to 1e-12; and the apply
  from the JAX package's own PC data carried across with
  ``interop.line_pc_from_numpy``.
"""


import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adflow_torch.solvers import dadi, krylov, linpc, newton
from adflow_tpu.solvers import dadi as jdadi
from adflow_tpu.solvers import krylov as jkrylov
from adflow_tpu.solvers import linpc as jlinpc
from adflow_tpu.solvers import newton as jnewton
from tests.torch_pairs import CASES, newton_pair, pc_pair
from tests.torch_pairs import rel as _rel

TOL = 1e-12


@pytest.mark.parametrize("restarts", [1, 2])
def test_gmres_matches_jax(restarts):
    rng = np.random.default_rng(1)
    n = 60
    A = 4.0 * np.eye(n) + 0.5 * rng.standard_normal((n, n))
    d = np.diag(A).copy()
    b = rng.standard_normal(n)
    sj = jkrylov.gmres(lambda v: jnp.asarray(A) @ v, jnp.asarray(b), m=12,
                       restarts=restarts, tol=1e-8,
                       precond=lambda v: v / jnp.asarray(d))
    st = krylov.gmres(lambda v: torch.from_numpy(A) @ v, torch.from_numpy(b),
                      m=12, restarts=restarts, tol=1e-8,
                      precond=lambda v: v / torch.from_numpy(d))
    assert st.iters == int(sj.iters) == 12 * restarts
    assert st.matvecs == restarts + st.iters
    assert abs(st.res_norm - float(sj.res_norm)) <= TOL * float(sj.res_norm)
    assert st.converged == bool(sj.converged)
    assert _rel(sj.x, st.x.numpy()) < TOL
    # the estimate is the true residual of x
    true = np.linalg.norm(b - A @ st.x.numpy())
    assert abs(true - st.res_norm) < 1e-9 * true


def test_gmres_converges_early_like_jax():
    rng = np.random.default_rng(2)
    n = 40
    A = 6.0 * np.eye(n) + 0.3 * rng.standard_normal((n, n))
    b = rng.standard_normal(n)
    sj = jkrylov.gmres(lambda v: jnp.asarray(A) @ v, jnp.asarray(b), m=30,
                       restarts=2, tol=1e-6)
    st = krylov.gmres(lambda v: torch.from_numpy(A) @ v, torch.from_numpy(b),
                      m=30, restarts=2, tol=1e-6)
    assert st.converged and st.iters == int(sj.iters) < 30
    assert st.matvecs == 1 + st.iters
    assert _rel(sj.x, st.x.numpy()) < TOL


def test_line_solves_match_jax():
    rng = np.random.default_rng(4)
    n, b = 7, 5
    A = rng.standard_normal((3, 4, b, b)) + 6.0 * np.eye(b)
    B = rng.standard_normal((3, 4, b, 2))
    assert _rel(jlinpc.solve_small(jnp.asarray(A), jnp.asarray(B)),
                linpc.solve_small(torch.from_numpy(A),
                                  torch.from_numpy(B)).numpy()) < TOL
    L, U = (rng.standard_normal((n, 3, b, b)) for _ in range(2))
    D = rng.standard_normal((n, 3, b, b)) + 8.0 * np.eye(b)
    r = rng.standard_normal((n, 3, b))
    want = jlinpc.block_tridiag_solve(*(jnp.asarray(a) for a in (L, D, U, r)))
    got = linpc.block_tridiag_solve(*(torch.from_numpy(a)
                                      for a in (L, D, U, r)))
    assert _rel(want, got.numpy()) < TOL
    lo, up = (rng.standard_normal((n, 3, 2)) for _ in range(2))
    dg = rng.standard_normal((n, 3, 2)) + 5.0
    rs = rng.standard_normal((n, 3, 2, 1))
    want = jdadi.tridiag_solve(*(jnp.asarray(a) for a in (lo, dg, up, rs)))
    got = dadi.tridiag_solve(*(torch.from_numpy(a)
                               for a in (lo, dg, up, rs)))
    assert _rel(want, got.numpy()) < TOL


def test_flux_jacobians_match_jax():
    rng = np.random.default_rng(6)
    w = np.array([1.0, 0.5, 0.1, -0.2, 2.5]) * (
        1.0 + 0.05 * rng.standard_normal((4, 3, 5)))
    s = rng.standard_normal((4, 3, 3))
    want = jlinpc.flux_jacobians(jnp.asarray(w), jnp.asarray(s))
    got = linpc.flux_jacobians(torch.from_numpy(w), torch.from_numpy(s))
    assert _rel(want, got.numpy()) < TOL
    # float32 in, float32 out (the card's working dtype)
    got32 = linpc.flux_jacobians(torch.from_numpy(w).float(),
                                 torch.from_numpy(s).float())
    assert got32.dtype == torch.float32
    assert _rel(want, got32.numpy()) < 1e-6


@pytest.fixture(scope="module", params=sorted(CASES))
def pc_case(request):
    """Both packages' Newton functions at one seeded perturbed state."""
    return newton_pair(request.param)


def test_line_pc_apply_matches_jax(pc_case):
    js, ts, jf, tf, w0 = pc_case
    rng = np.random.default_rng(8)
    # the JAX package's PC data, and the same carried across
    pj, carried = pc_pair(jf, w0, 7.0, js)
    axes, kappa = newton._pc_params(ts.options)
    pt = tf.build_pc(torch.from_numpy(w0), 7.0, axes=axes, kappa=kappa)
    v = rng.standard_normal(w0.shape)
    want = jnewton.pc_apply_vec(pj, jf.packer, jnp.asarray(v))
    got = newton.pc_apply_vec(pt, tf.packer, torch.from_numpy(v))
    assert _rel(want, got.numpy()) < TOL
    got = newton.pc_apply_vec(carried, tf.packer, torch.from_numpy(v))
    assert _rel(want, got.numpy()) < TOL
    assert all(pt[i].turb_scale == pj[i].turb_scale for i in range(len(pj)))
