"""Port parity for the multigrid (AMG) preconditioner (solvers/amg.py), in
float64 on the CPU, at the seeded perturbed free stream of
tests/torch_pairs.py (the 16x8x8 Euler wing and the 16x12 RANS-SA
plate):

- ``build_stencil_jacobian``, the scalar split (with the turbulence rows
  on the RANS-SA wing) and the matrix split: every stencil array to 1e-12;
- ``stencil_apply`` to 1e-12, and <A v, u> = <v, A^T u> through
  ``stencil_transpose`` to 1e-12;
- ``coarsen_stencil`` equal to P^T A P with the piecewise-constant P to
  1e-12;
- ``amg_pc_apply``, forward and transposed, against the JAX package's on
  data carried across by ``interop.amg_pc_from_numpy`` and on data the
  port built: 1e-10;
- slow: one ANK step with ``ANKGlobalPreconditioner: "multigrid"`` (stats
  and state to 1e-10) and ``solveAdjoint`` with
  ``adjointGlobalPreconditioner: "multigrid"`` (psi and the totals to
  1e-9).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adflow_torch.interop import amg_pc_from_numpy
from adflow_torch.solvers import amg
from adflow_torch.solvers import multigrid as mg
from adflow_tpu.solvers import amg as jamg
from tests.torch_pairs import rel, variant_pair

TOL = 1e-12
PC_TOL = 1e-10
MATRIX = {"discretization": "central plus matrix dissipation"}


@pytest.fixture(scope="module")
def euler():
    return variant_pair("euler_wing")


@pytest.fixture(scope="module")
def rans():
    # the 16x12 RANS-SA plate: turbulence rows at a third of the wing
    # pair's set-up cost
    return variant_pair("rans_plate")


def _dtinv(pair, seed=2):
    shape = tuple(n - 4 for n in pair.wt[0].shape[:3])
    return np.random.default_rng(seed).uniform(0.5, 1.5, shape)


def _stencils(pair, cfg_changes=None, kappa=0.5):
    """Both packages' stencil of block 0 at the pair's filled state."""
    js, ts = pair.js, pair.ts
    cj = dataclasses.replace(js.cfg, **(cfg_changes or {}))
    ct = dataclasses.replace(ts.cfg, **(cfg_changes or {}))
    d = _dtinv(pair)
    oj = jamg.build_stencil_jacobian(pair.wj[0], js.metrics_list[0], cj,
                                     js.ref, jnp.asarray(d), kappa)
    ot = amg.build_stencil_jacobian(pair.wt[0], ts.metrics_list[0], ct,
                                    ts.ref, torch.from_numpy(d), kappa)
    return oj, ot


def _fields(op):
    out = {"D": [op.D]}
    for k in ("L", "U", "Lt", "Ut"):
        out[k] = list(getattr(op, k) or ())
    out["Dt"] = [] if op.Dt is None else [op.Dt]
    return out


def _check_ops(oj, ot, tol=TOL):
    fj, ft = _fields(oj), _fields(ot)
    for k in fj:
        assert len(fj[k]) == len(ft[k]), k
        for a, b in zip(fj[k], ft[k]):
            assert rel(a, b.numpy()) < tol, k
    assert oj.turb_scale == ot.turb_scale


@pytest.mark.parametrize("case,changes", [("euler", None),
                                          ("rans", None),
                                          ("euler", MATRIX)],
                         ids=["scalar", "scalar turbulence", "matrix"])
def test_stencil_jacobian_matches_jax(case, changes, request):
    oj, ot = _stencils(request.getfixturevalue(case), changes)
    _check_ops(oj, ot)
    assert (ot.Dt is not None) == (case == "rans")


@pytest.mark.parametrize("case", ["euler", "rans"])
def test_stencil_apply_and_transpose(case, request):
    pair = request.getfixturevalue(case)
    oj, ot = _stencils(pair)
    rng = np.random.default_rng(5)
    shape = tuple(ot.D.shape[:3]) + (pair.wt[0].shape[-1],)
    v, u = rng.standard_normal(shape), rng.standard_normal(shape)
    want = jamg.stencil_apply(oj, jnp.asarray(v))
    got = amg.stencil_apply(ot, torch.from_numpy(v))
    assert rel(want, got.numpy()) < TOL
    _check_ops(jamg.stencil_transpose(oj), amg.stencil_transpose(ot))
    lhs = float(torch.sum(got * torch.from_numpy(u)))
    rhs = float(torch.sum(torch.from_numpy(v) * amg.stencil_apply(
        amg.stencil_transpose(ot), torch.from_numpy(u))))
    assert abs(lhs - rhs) < TOL * abs(lhs)


@pytest.mark.parametrize("case,changes", [("euler", None), ("rans", None),
                                          ("euler", MATRIX)],
                         ids=["scalar", "scalar turbulence", "matrix"])
def test_coarsen_stencil_is_galerkin(case, changes, request):
    """The coarse stencil equals R A P with the piecewise-constant P and
    R = P^T, and the JAX package's coarse stencil."""
    pair = request.getfixturevalue(case)
    oj, ot = _stencils(pair, changes)
    f = mg.coarsen_factors(ot.D.shape[:3])
    opc = amg.coarsen_stencil(ot, f)
    _check_ops(jamg.coarsen_stencil(oj, f), opc)
    cd = tuple(opc.D.shape[:3]) + (pair.wt[0].shape[-1],)
    vc = torch.from_numpy(np.random.default_rng(6).standard_normal(cd))
    rap = mg._pool_sum(amg.stencil_apply(ot, mg.prolong_correction(vc, f)),
                       f)
    acv = amg.stencil_apply(opc, vc)
    assert rel(acv.numpy(), rap.numpy()) < TOL


def _carried(dj):
    """The JAX package's AMGPCData carried into the port."""
    lp = dj.line
    line = dict(
        axes=lp.axes,
        mean=[tuple(np.asarray(a) for a in t) for t in lp.mean],
        turb=[None if t is None else tuple(np.asarray(a) for a in t)
              for t in lp.turb],
        dscalar=np.asarray(lp.dscalar), turb_scale=lp.turb_scale)

    def per_axis(t):
        return None if t is None else [np.asarray(a) for a in t]

    ops = [dict(D=np.asarray(o.D), L=per_axis(o.L), U=per_axis(o.U),
                Dt=None if o.Dt is None else np.asarray(o.Dt),
                Lt=per_axis(o.Lt), Ut=per_axis(o.Ut),
                turb_scale=o.turb_scale) for o in dj.ops]
    return amg_pc_from_numpy(line, ops, dj.factors, dj.axis, dj.n_smooth,
                             dj.coarse_damp, dj.transposed)


@pytest.mark.parametrize("case", [
    "euler", pytest.param("rans", marks=pytest.mark.slow)])
@pytest.mark.parametrize("transpose", [False, True],
                         ids=["forward", "transposed"])
def test_amg_pc_apply_matches_jax(case, transpose, request):
    """3 levels (the wing's 16x8x8, 8x4x4, 4x2x2; the plate's 16x12x1,
    8x6x1, 4x3x1), kappa 0.25: the apply on the JAX package's data carried
    across and on the port's own build. The plate's cases are slow (the
    JAX package's op-by-op line solves with turbulence rows, 11-22 s
    each)."""
    pair = request.getfixturevalue(case)
    js, ts = pair.js, pair.ts
    d = _dtinv(pair)
    kw = dict(levels=3, n_smooth=1, axes=(1, 0, 2), kappa=0.25,
              transpose=transpose)
    dj = jamg.build_amg_pc(pair.wj[0], js.metrics_list[0], js.cfg, js.ref,
                           jnp.asarray(d), **kw)
    dt = amg.build_amg_pc(pair.wt[0], ts.metrics_list[0], ts.cfg, ts.ref,
                          torch.from_numpy(d), **kw)
    assert dt.factors == dj.factors and len(dt.ops) == 3
    for a, b in zip(dj.ops, dt.ops):
        _check_ops(a, b)
    shape = tuple(dt.ops[0].D.shape[:3]) + (pair.wt[0].shape[-1],)
    v = np.random.default_rng(7).standard_normal(shape)
    want = np.asarray(jamg.amg_pc_apply(dj, jnp.asarray(v)))
    for data in (_carried(dj), dt):
        got = amg.amg_pc_apply(data, torch.from_numpy(v))
        assert rel(want, got.numpy()) < PC_TOL


@pytest.mark.slow
def test_amg_ank_step_matches_jax():
    """One ANK step of the Euler wing with the multigrid PC (the JAX
    package's PC data carried across), through the JAX package's and the
    port's ``make_ank_step``. Slow: the JAX package compiles the step."""
    from adflow_torch.solvers import newton
    from adflow_tpu.solvers import newton as jnewton
    from tests.torch_pairs import CFL, check_stats

    pair = variant_pair("euler_wing", ANKGlobalPreconditioner="multigrid")
    js, ts, jf, tf, w0 = pair.js, pair.ts, pair.jf, pair.tf, pair.w0
    axes, kappa = jnewton._pc_params(js.options)
    kw = dict(pc_kind="multigrid", amg_levels=3, amg_nsmooth=1)
    pj = jf.build_pc(jnp.asarray(w0), CFL, axes=axes, kappa=kappa, **kw)
    pt = [_carried(d) for d in pj]
    mine = tf.build_pc(torch.from_numpy(w0), CFL, axes=axes, kappa=kappa,
                       **kw)
    for a, b in zip(pj[0].ops, mine[0].ops):
        _check_ops(a, b)
    wj, sj = jnewton.make_ank_step(jf, js.options)(jnp.asarray(w0),
                                                   jnp.asarray(CFL), pj)
    res = newton.make_ank_step(tf, ts.options)(torch.from_numpy(w0), CFL,
                                               pt)
    check_stats(sj, res.stats.numpy())
    assert rel(wj, res.w.numpy()) < 1e-10
    assert rel(w0, res.w.numpy()) > 1e-6 and res.stats[4] >= 1


@pytest.mark.slow
def test_amg_adjoint_matches_jax():
    """``evalFunctionsSens`` of cl on the Euler wing with the transposed
    multigrid PC: psi and every total to 1e-9. Slow: the JAX package's
    op-by-op adjoint."""
    from tests.torch_pairs import check_sens, sens_pair

    pair = sens_pair("euler_wing", ["cl"],
                     adjointGlobalPreconditioner="multigrid",
                     adjointMaxIter=60, adjointSubspaceSize=30)
    check_sens(pair, "cl", converged=pair[0].adjointFailed is False)
