"""The port's adjoint pieces against the JAX package, float64 on the CPU,
on the cases of tests/torch_pairs.py at their seeded perturbed state.

- ``traced_reference_state`` and ``traced_winf``, and their Jacobians with
  respect to the design variables, for both lift axes, to 1e-12;
- the transposed line PC (``line_pc_apply_transposed`` through the
  adjoint's ``_transposed_line_pc``) against the JAX package's on random
  vectors, turbulence rows included, to 1e-10; and <M^-1 u, v> = <u,
  M^-T v> to 1e-12;
- the dot-product identities of ``computeJacobianVectorProductFwd/Bwd``
  (the JAX package's tests/test_adjoint.py:44-70): <J v, u> = <v, J^T u>
  in w and x, and the functions' jvp against their gradient, to 1e-12;
- the transposed multigrid PC (``_transposed_amg_pc``,
  adjointGlobalPreconditioner='multigrid') against the JAX package's to
  1e-10;
- the adjoint's functions with a user surface and cp targets (the
  gradients of their functions to 1e-10), and kept across aero problems,
  as the JAX package keeps them.

The solve itself is in test_torch_adjoint_solve.py (Euler wing),
test_torch_adjoint_rans.py and test_torch_adjoint_frozen.py (RANS plate).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adflow_torch.adjoint import api as tapi
from adflow_torch.core.refstate import AeroProblem
from adflow_torch.interop import params_from_numpy
from adflow_torch.solvers.newton import pc_apply_vec
from adflow_tpu.adjoint import api as japi
from tests.torch_pairs import CASES, adjoint_pair, jax_params, rel

TOL = 1e-12
PC_TOL = 1e-10
FUNC = {"euler_wing": "cl", "rans_plate": "cd"}
FIELDS = ("u_inf", "mu_inf", "nu_tilde_inf", "vel_dir", "drag_dir",
          "lift_dir", "q_inf", "t_inf_dim", "p_ref_dim", "moment_ref")


@pytest.fixture(scope="module", params=sorted(CASES))
def pair(request):
    return (request.param,) + adjoint_pair(request.param)


def _jax_traced(base, params):
    ref = japi.traced_reference_state(base, params)
    return jnp.concatenate([jnp.ravel(jnp.asarray(getattr(ref, f)))
                            for f in FIELDS] + [japi.traced_winf(ref)])


def _torch_traced(base, params):
    ref = tapi.traced_reference_state(base, params)
    return torch.cat([torch.as_tensor(getattr(ref, f),
                                      dtype=torch.float64).reshape(-1)
                      for f in FIELDS] + [tapi.traced_winf(ref)])


@pytest.mark.parametrize("lift_index", [2, 3])
def test_traced_reference_state_matches_jax(pair, lift_index):
    _, js, ts = pair
    jbase = dataclasses.replace(js.ref, lift_index=lift_index)
    tbase = dataclasses.replace(ts.ref, lift_index=lift_index)
    pj = jax_params(js)
    pt = params_from_numpy(pj)
    assert rel(_jax_traced(jbase, pj), _torch_traced(tbase, pt).numpy()) \
        < TOL
    want = jax.jacfwd(lambda p: _jax_traced(jbase, p))(pj)
    got = torch.func.jacfwd(lambda p: _torch_traced(tbase, p))(pt)
    assert set(want) == set(got)
    for k in want:
        assert rel(want[k], got[k].numpy()) < TOL, k
    assert np.abs(want["mach"]).max() > 0.0


def test_transposed_line_pc_matches_jax(pair):
    case, js, ts = pair
    jn, tn = js._newton_fns(), ts._newton_fns()
    wj, wt = js._wx_vecs()[0], ts._wx_vecs()[0]
    rng = np.random.default_rng(5)
    v = rng.standard_normal(wt.shape)
    want = japi._transposed_line_pc(jn, wj)(jnp.asarray(v))
    got = tapi._transposed_line_pc(tn, wt)(torch.tensor(v))
    assert rel(want, got.numpy()) < PC_TOL
    # the transpose of the forward apply, from the same PC data
    data = tn.collect_pc_data(wt, tapi.PC_CFL)
    u = torch.tensor(rng.standard_normal(wt.shape))
    lhs = float(pc_apply_vec(data, tn.packer, u) @ torch.tensor(v))
    rhs = float(u @ got)
    assert abs(lhs - rhs) < TOL * abs(lhs)
    if case == "rans_plate":
        # the turbulence rows take part, scaled by turbResScale
        assert data[0].turb_scale is not None
        assert np.abs(got.numpy().reshape(-1, 6)[:, 5]).max() > 0.0


def test_jacobian_vector_products_are_transposes(pair):
    """<J v, u> = <v, J^T u> in w and x together, and the functions' jvp
    equals their gradient against the same direction."""
    case, _, ts = pair
    rng = np.random.default_rng(0)
    wvec, xvec = ts._wx_vecs()
    wd = rng.standard_normal(wvec.shape)
    xd = rng.standard_normal(xvec.shape)
    rbar = rng.standard_normal(wvec.shape)
    rdot, fdot = ts.computeJacobianVectorProductFwd(
        wDot=wd, xVDot=torch.tensor(xd), residualDeriv=True, funcDeriv=True)
    gw, gx = ts.computeJacobianVectorProductBwd(
        resBar=rbar, wDeriv=True, xVDeriv=True)
    assert isinstance(rdot, np.ndarray) and isinstance(gx, np.ndarray)
    lhs = float(rdot @ rbar)
    assert abs(lhs - (gw @ wd + gx @ xd)) < TOL * abs(lhs)
    name = FUNC[case]
    fw, fx = ts.computeJacobianVectorProductBwd(
        funcsBar={name: 1.0}, wDeriv=True, xVDeriv=True)
    assert abs(fdot[name] - (fw @ wd + fx @ xd)) < TOL * abs(fdot[name])


def test_user_surface_and_cp_target_adjoint_match_jax(pair):
    """The adjoint's functions take the user integration surfaces and the
    cp targets: the gradients in w, x and the design variables of a user
    surface's mass flow and total pressure (the wing, a plane across its
    wake) and of cperror2, to 1e-10. The plate, one cell thick, holds no
    user surface in either package: the association's padded cell centres
    need two cells along each axis (``_padded_centers``)."""
    from tests.torch_pairs import (
        add_planes, check_function_gradients, plane, wall_targets)

    case, js, ts = pair
    names = []
    if case == "euler_wing":
        names = add_planes(js, ts, case)[:2]
    else:
        for s in (js, ts):
            with pytest.raises(IndexError):
                s.addIntegrationSurface(
                    plane((0.05, 0.01), (0.45, 0.04), 0.5), "plane")
    tgt = wall_targets(ts)
    for s in (js, ts):
        s.setTargetCp(tgt)
        s._afns = None
    check_function_gradients(js, ts, names + ["cperror2"], jit=True)
    for s in (js, ts):
        s._user_surfaces, s._cp_targets, s._afns = [], None, None


def test_transposed_amg_pc_matches_jax(pair):
    """adjointGlobalPreconditioner='multigrid': the adjoint's transposed
    Galerkin multigrid PC (``_transposed_amg_pc``) against the JAX
    package's on a random vector, turbulence rows included, to 1e-10. (It
    is not the exact transpose of the forward multigrid apply: its coarse
    line sweeps run on the transposed stencils, as in the JAX package.)"""
    case, js, ts = pair
    opts = dict(adjointGlobalPreconditioner="multigrid", adjointAMGLevels=3)
    js.options, ts.options = (js.options.replace(**opts),
                              ts.options.replace(**opts))
    jn, tn = js._newton_fns(), ts._newton_fns()
    wj, wt = js._wx_vecs()[0], ts._wx_vecs()[0]
    rng = np.random.default_rng(6)
    v = rng.standard_normal(wt.shape)
    want = japi._transposed_amg_pc(jn, js, wj)(jnp.asarray(v))
    got = tapi._transposed_amg_pc(tn, ts, wt)(torch.tensor(v))
    assert rel(want, got.numpy()) < PC_TOL
    if case == "rans_plate":
        # the turbulence rows take part
        assert np.abs(got.numpy().reshape(-1, 6)[:, 5]).max() > 0.0


def test_adjoint_fns_kept_across_aero_problems(pair):
    """The adjoint's and the PC's functions are built on first use and kept
    when the aero problem changes (the JAX package's ``_afns`` and
    ``_nfns``), so their base reference state is the first problem's."""
    _, js, ts = pair
    fns, nfns, ap = ts._adjoint_fns(), ts._newton_fns(), ts.curAP
    jfns, jap = js._adjoint_fns(), js.curAP
    other = dict(name="other", mach=0.5, alpha=1.0)
    ts.setAeroProblem(AeroProblem(**other))
    js.setAeroProblem(type(js.curAP)(**other))
    assert ts._adjoint_fns() is fns and ts._newton_fns() is nfns
    assert js._adjoint_fns() is jfns
    ts.setAeroProblem(ap)
    js.setAeroProblem(jap)
