"""The port's outer solves against the JAX package, float64 on the CPU:

- ``solveCL``: one secant iterate (three solves from the same start, 25 RK
  cycles each) with the same iterates (alpha, cl) to 1e-9; slow: the
  converged secant of tests/test_io_functions.py::test_solve_cl_secant
  (ANK) and the Broyden ``solveTargetFuncs`` of
  tests/test_api_extras.py::test_solve_target_funcs, iterate by iterate;
- ``solveErrorEstimate`` and ``propagateUncertainty`` at the Euler wing's
  seeded perturbed free stream, to 1e-9 (the JAX adjoint of cl under
  ``jax.jit``; slow: its eager adjoints of cl and cd), and the
  surface-sensitivity file of that adjoint, to 1e-10.
"""

import numpy as np
import pytest

import adflow_torch.meshgen.analytic as tmeshgen
import adflow_tpu.meshgen.analytic as jmeshgen
from adflow_torch.api.solver import ADFLOW
from adflow_torch.core.refstate import AeroProblem
from adflow_tpu.api.solver import ADFLOW as JaxADFLOW
from adflow_tpu.core.refstate import AeroProblem as JaxAP
from tests import torch_pairs

TOL = 1e-9
RK = {"equationType": "euler", "useANKSolver": False, "useNKSolver": False,
      "nCycles": 25, **torch_pairs.QUIET}


def recorded(solver, name):
    """Record (alpha, f) at each ``evalFunctions`` the outer solve makes."""
    log = []
    evaluate = solver.evalFunctions

    def record(ap, funcs, evalFuncs=None, ignoreMissing=True):
        out = evaluate(ap, funcs, evalFuncs, ignoreMissing)
        log.append((ap.alpha, out[f"{ap.name}_{name}"]))
        return out

    solver.evalFunctions = record
    return log


def pair(options, mesh_kw, ap_kw):
    js = JaxADFLOW(options=options,
                   mesh=jmeshgen.naca0012_omesh(**mesh_kw))
    ts = ADFLOW(options=options, mesh=tmeshgen.naca0012_omesh(**mesh_kw),
                device="cpu")
    return (js, JaxAP(**ap_kw)), (ts, AeroProblem(**ap_kw))


def check_iterates(logs, tol=TOL):
    (lj, lt) = logs
    assert len(lj) == len(lt)
    for (aj, fj), (at, ft) in zip(lj, lt):
        assert abs(at - aj) <= tol * max(abs(aj), 1.0), (aj, at)
        assert abs(ft - fj) <= tol * max(abs(fj), 1e-3), (fj, ft)


def test_solve_cl_one_secant_iterate():
    """cl at alpha0 and alpha0 + delta, one secant step and its cl."""
    runs = pair(RK, dict(ni=32, nj=12),
                dict(name="clt", mach=0.5, alpha=1.0, evalFuncs=["cl"]))
    logs, alphas = [], []
    for s, ap in runs:
        logs.append(recorded(s, "cl"))
        alphas.append(s.solveCL(ap, CLStar=0.2, alpha0=1.0, delta=0.5,
                                tol=1e-12, maxIter=1))
    assert [len(lg) for lg in logs] == [3, 3]
    check_iterates(logs)
    assert abs(alphas[1] - alphas[0]) <= TOL * abs(alphas[0])
    assert alphas[1] == logs[1][-1][0]


@pytest.mark.slow
def test_solve_cl_secant():
    """tests/test_io_functions.py::test_solve_cl_secant on both packages,
    each solve converged to 1e-11 with NK after ANK (at that test's 1e-8
    the two packages' converged cl part by 1e-8 relative, their steps
    rounding differently)."""
    opts = dict(RK, useANKSolver=True, useNKSolver=True, nCycles=200,
                L2Convergence=1e-11)
    runs = pair(opts, dict(ni=48, nj=16),
                dict(name="clt", mach=0.5, alpha=1.0, evalFuncs=["cl"]))
    logs, alphas = [], []
    for s, ap in runs:
        logs.append(recorded(s, "cl"))
        alphas.append(s.solveCL(ap, CLStar=0.2, alpha0=1.0, delta=0.5,
                                tol=2e-4))
    check_iterates(logs)
    assert abs(logs[1][-1][1] - 0.2) < 2e-4
    assert abs(alphas[1] - alphas[0]) <= TOL * abs(alphas[0])


@pytest.mark.slow
def test_solve_target_funcs():
    """tests/test_api_extras.py::test_solve_target_funcs on both
    packages: the Broyden iterates and the result."""
    opts = dict(RK, nCycles=60)
    runs = pair(opts, dict(ni=32, nj=12),
                dict(name="tt", mach=0.5, alpha=0.0))
    logs, outs = [], []
    for s, ap in runs:
        logs.append(recorded(s, "cl"))
        outs.append(s.solveTargetFuncs(ap, {"cl": 0.12}, {"alpha": 0.0},
                                       tol=5e-3, maxIter=8))
    check_iterates(logs)
    assert abs(logs[1][-1][1] - 0.12) < 5e-3
    assert abs(outs[1]["alpha"] - outs[0]["alpha"]) <= TOL


def check_estimate_and_uncertainty(js, ts, funcs):
    want = js.solveErrorEstimate(js.curAP, "cl")
    got = ts.solveErrorEstimate(ts.curAP, "cl")
    assert isinstance(got, float) and got != 0.0
    assert abs(got - want) <= TOL * abs(want), (got, want)
    uq = {"alpha": 0.1, "mach": 0.01}
    uj = js.propagateUncertainty(js.curAP, funcs, uq)
    ut = ts.propagateUncertainty(ts.curAP, funcs, uq)
    assert sorted(uj) == sorted(ut) == sorted(f"w_{f}" for f in funcs)
    for k in uj:
        assert ut[k] > 0.0
        assert abs(ut[k] - uj[k]) <= TOL * uj[k], (k, ut[k], uj[k])


@pytest.fixture(scope="module")
def jitted_wing():
    """The Euler wing's solvers with the JAX package's adjoint of cl under
    one ``jax.jit`` (``torch_pairs.jitted_sens``; its eager adjoint takes
    two minutes here); the JAX solver's ``solveAdjoint`` and
    ``evalFunctionsSens`` then return that psi and those totals."""
    js, ts = torch_pairs.adjoint_pair("euler_wing")
    _, _, sj, _ = torch_pairs.jitted_sens(js, ts, "cl")
    key = (js.curAP.name, "cl")
    js.solveAdjoint = lambda ap, objective: js._psi_cache[key]
    js.evalFunctionsSens = (
        lambda ap, sens, evalFuncs=None: sens.update(sj) or sens)
    return js, ts


def test_error_estimate_and_uncertainty(jitted_wing):
    check_estimate_and_uncertainty(*jitted_wing, ["cl"])


def test_surface_sensitivity(jitted_wing, tmp_path):
    """``writeSurfaceSensitivity`` of cl: the files of both packages
    parsed back (tests/test_torch_writers.py)."""
    from tests.test_torch_writers import both
    heads, vals = both(jitted_wing, tmp_path, "sens.dat",
                       lambda s, p: s.writeSurfaceSensitivity(p, "cl"))
    assert "dX dY dZ" in heads[0]
    assert any("FEQuadrilateral" in h for h in heads)
    assert np.abs(vals).max() > 0.0


@pytest.mark.slow
def test_error_estimate_and_uncertainty_eager():
    """The same with the JAX package's own eager adjoints, cl and cd."""
    js, ts = torch_pairs.adjoint_pair("euler_wing")
    check_estimate_and_uncertainty(js, ts, ["cl", "cd"])
