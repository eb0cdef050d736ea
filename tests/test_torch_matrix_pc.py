"""Port parity for the characteristic line-PC split of the upwind and
matrix-dissipation discretizations (solvers/linpc.py), their ANK steps
and the adjoint through matrix dissipation, in float64 on the CPU.

On the 16x8x8 Euler wing of tests/torch_pairs.py at its seeded perturbed
state:
- ``abs_flux_jacobians`` against the JAX package's ``vmap(jacfwd)`` to
  1e-12, float32 kept in float32;
- ``build_line_pc``'s split: the port's factors of (L, D, U) against those
  of the JAX package's (L, D, U) carried across with
  ``interop.line_pc_from_numpy``, to 1e-12 (the matrix case slow); one PC
  apply to 1e-10; the transposed apply <M^-1 u, v> = <u, M^-T v> to 1e-12;
- slow: one ANK step with matrix dissipation and one with upwind (Roe,
  van Albada) through ``torch_pairs.check_ank_step``, stats to 1e-10;
- the adjoint through matrix dissipation: the residual's vjp in w, x and
  the design variables (``check_residual_vjp``) to 1e-10, the adjoint's
  transposed PC against the JAX package's to 1e-10 and its identity to
  1e-12.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adflow_torch.adjoint import api as tapi
from adflow_torch.solvers import linpc, newton
from adflow_tpu.adjoint import api as japi
from adflow_tpu.solvers import linpc as jlinpc
from adflow_tpu.solvers import newton as jnewton
from tests.torch_pairs import (
    CFL, adjoint_pair, check_ank_step, check_residual_vjp, newton_pair,
    pc_pair, rel)

TOL = 1e-12
PC_TOL = 1e-10
MATRIX = {"discretization": "central plus matrix dissipation"}
UPWIND = {"discretization": "upwind", "riemannSolver": "Roe",
          "limiter": "van Albada"}


def test_abs_flux_jacobians_match_jax():
    rng = np.random.default_rng(6)
    w = np.array([1.0, 0.5, 0.1, -0.2, 2.5]) * (
        1.0 + 0.05 * rng.standard_normal((4, 3, 5)))
    s = rng.standard_normal((4, 3, 3))
    want = jlinpc.abs_flux_jacobians(jnp.asarray(w), jnp.asarray(s))
    got = linpc.abs_flux_jacobians(torch.from_numpy(w), torch.from_numpy(s))
    assert got.shape == (4, 3, 5, 5)
    assert rel(want, got.numpy()) < TOL
    # float32 in, float32 out (the card's working dtype)
    got32 = linpc.abs_flux_jacobians(torch.from_numpy(w).float(),
                                     torch.from_numpy(s).float())
    assert got32.dtype == torch.float32
    assert rel(want, got32.numpy()) < 1e-5


@pytest.fixture(scope="module", params=[
    pytest.param("matrix", marks=pytest.mark.slow), "upwind"])
def pair(request):
    """Both discretizations take the split; the matrix case is slow (its
    split test takes 28 s on one CPU worker with the pair's set-up)."""
    return newton_pair("euler_wing",
                       **(MATRIX if request.param == "matrix" else UPWIND))


def test_line_pc_split_matches_jax(pair):
    js, ts, jf, tf, w0 = pair
    pj, carried = pc_pair(jf, w0, CFL, js)
    axes, kappa = newton._pc_params(ts.options)
    pt = tf.build_pc(torch.from_numpy(w0), CFL, axes=axes, kappa=kappa)
    # the split's full 5x5 diagonal, not the scalar one
    d = np.asarray(pj[0].mean[0][1])
    assert np.abs(d - np.eye(5) * d[..., :1, :1]).max() > 1e-3 * np.abs(
        d).max()
    for dt, dc in zip(pt, carried):
        for ft, fc in zip(dt.mean, dc.mean):
            for a, b in zip(ft, fc):
                assert rel(b.numpy(), a.numpy()) < TOL
    rng = np.random.default_rng(8)
    v = rng.standard_normal(w0.shape)
    want = jnewton.pc_apply_vec(pj, jf.packer, jnp.asarray(v))
    got = newton.pc_apply_vec(pt, tf.packer, torch.from_numpy(v))
    assert rel(want, got.numpy()) < PC_TOL
    # the transposed apply is the transpose of the apply
    u = torch.from_numpy(rng.standard_normal(w0.shape))
    tv = tf.packer.pack([linpc.line_pc_apply_transposed(d, b) for d, b in
                         zip(pt, tf.packer.unpack(torch.from_numpy(v)))])
    lhs = float(newton.pc_apply_vec(pt, tf.packer, u) @ torch.from_numpy(v))
    assert abs(lhs - float(u @ tv)) < TOL * abs(lhs)


@pytest.mark.slow
def test_ank_step_matches_jax(pair):
    """Slow: the JAX package compiles the whole ANK step, 35-45 s a
    discretization on one CPU worker."""
    res = check_ank_step(pair, "coupled", {})
    # residual, one per matvec, three merits, new residual
    assert res.res_evals == 1 + res.krylov_matvecs + 3 + 1


@pytest.fixture(scope="module")
def adjoint():
    return adjoint_pair("euler_wing", **MATRIX)


def test_matrix_residual_vjp_matches_jax(adjoint):
    check_residual_vjp(*adjoint, jit=True)


def test_matrix_transposed_pc_matches_jax(adjoint):
    js, ts = adjoint
    jn, tn = js._newton_fns(), ts._newton_fns()
    wj, wt = js._wx_vecs()[0], ts._wx_vecs()[0]
    rng = np.random.default_rng(5)
    v = rng.standard_normal(wt.shape)
    want = japi._transposed_line_pc(jn, wj)(jnp.asarray(v))
    got = tapi._transposed_line_pc(tn, wt)(torch.tensor(v))
    assert rel(want, got.numpy()) < PC_TOL
    data = tn.collect_pc_data(wt, tapi.PC_CFL)
    u = torch.tensor(rng.standard_normal(wt.shape))
    lhs = float(newton.pc_apply_vec(data, tn.packer, u) @ torch.tensor(v))
    assert abs(lhs - float(u @ got)) < TOL * abs(lhs)
