"""The port's adjoint on overset meshes against the JAX package, float64
on the CPU: through the overset fill and the iblank masks (the Euler
airfoil in its generated background) and through the overlap weights and
the zipper's gap triangles (tests/test_zipper.py's two-patch mesh under an
empty cut, which makes it an overset mesh and gives it both): the
residual's vjp in w, x and every design variable and the functions'
gradients to 1e-10, the dot-product identity of
``computeJacobianVectorProductFwd/Bwd`` to 1e-12; slow: the
``evalFunctionsSens`` totals after a fixed 20 GMRES iterations, xv
included, to 1e-9 (the JAX side under one ``jax.jit``). The user surfaces'
and cperror2's adjoints are in tests/test_torch_usersurf.py and
tests/test_torch_adjoint.py."""

import numpy as np
import pytest

TOL = 1e-12


@pytest.fixture(scope="module")
def tp():
    from tests import torch_pairs
    return torch_pairs


@pytest.fixture(scope="module", params=["overset airfoil", "zipper"])
def adjoint_pair(request, tp):
    """Both packages' solvers for the adjoint through the overset fill (the
    Euler airfoil in its background) or through the overlap weights and
    the zipper (the Euler two-patch mesh under an empty cut, which makes
    it an overset mesh), at the seeded perturbed state."""
    if request.param == "overset airfoil":
        js, ts = tp.overset_solvers(
            tp.OVERSET_MESHES["airfoil_background"][0], **tp.FIXED_20)
        func = "cl"
    else:
        js, ts = tp.overset_solvers(
            lambda p: tp.two_patch_mesh(p),
            lambda bi, c: np.zeros(len(c), bool),
            ap=dict(name="zp", mach=0.5, alpha=3.0), **tp.FIXED_20)
        assert ts.zipper_gaps is not None and ts.zipper_gaps.n_tris > 0
        func = "cfz"      # the walls' normal force (they lie in z = 0)
    w0 = tp.perturbed(np.asarray(js._wx_vecs()[0]), ts._newton_packer().nw)
    js.setStates(w0)
    ts.setStates(w0)
    return request.param, js, ts, func


def test_adjoint_vjp_and_gradients_match_jax(adjoint_pair, tp):
    _, js, ts, func = adjoint_pair
    tp.check_residual_vjp(js, ts, jit=True)
    tp.check_function_gradients(js, ts, [func], jit=True)


def test_dot_product_identity(adjoint_pair):
    """<J v, u> = <v, J^T u> in w and x through the overset fill."""
    _, _, ts, func = adjoint_pair
    rng = np.random.default_rng(0)
    wvec, xvec = ts._wx_vecs()
    wd, xd = rng.standard_normal(wvec.shape), rng.standard_normal(xvec.shape)
    rbar = rng.standard_normal(wvec.shape)
    rdot = ts.computeJacobianVectorProductFwd(wDot=wd, xVDot=xd,
                                              residualDeriv=True)
    gw, gx = ts.computeJacobianVectorProductBwd(resBar=rbar, wDeriv=True,
                                                xVDeriv=True)
    lhs = float(rdot @ rbar)
    assert abs(lhs - (gw @ wd + gx @ xd)) < TOL * abs(lhs)


@pytest.mark.slow
def test_adjoint_sens_match_jax(adjoint_pair, tp):
    _, js, ts, func = adjoint_pair
    tp.check_sens(tp.jitted_sens(js, ts, func), func, converged=False)
