"""Port parity for the slice as a whole: the steady RANS-SA Runge-Kutta solve.

Both packages run ``ADFLOW`` on ``wing_omesh(16, 8, 8, viscous=True)`` with
RANS, ``useANKSolver=False`` and 25 RK cycles in float64 on the CPU. The
residual history, the final interior states and ``evalFunctions`` cl/cd
agree to 1e-9 relative. The port refuses to start without a card unless the
caller names a device, and none of its modules imports JAX or the JAX
package.
"""

import subprocess
import sys

import numpy as np
import pytest
import torch

from adflow_tpu.api.solver import ADFLOW as JaxADFLOW
from adflow_tpu.core.refstate import AeroProblem as JaxAP
from adflow_tpu.meshgen.analytic import wing_omesh as jax_wing
from adflow_torch.api.solver import ADFLOW
from adflow_torch.core.refstate import AeroProblem
from adflow_torch.meshgen.analytic import wing_omesh

OPTS = {"equationType": "RANS", "useANKSolver": False, "useNKSolver": False,
        "nCycles": 25, "printIterations": False, "printTiming": False}
AP = dict(name="m6", mach=0.84, alpha=3.06, reynolds=11.72e6,
          evalFuncs=["cl", "cd"])
TOL = 1e-9


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / (np.abs(a).max() + 1e-300))


@pytest.fixture(scope="module")
def both_solves():
    jax_solver = JaxADFLOW(options=OPTS,
                           mesh=jax_wing(ni=16, nj=8, nk=8, viscous=True))
    jax_ap = JaxAP(**AP)
    jax_solver(jax_ap)
    jax_funcs = jax_solver.evalFunctions(jax_ap, {})

    solver = ADFLOW(options=OPTS, mesh=wing_omesh(ni=16, nj=8, nk=8,
                                                  viscous=True),
                    device="cpu")
    ap = AeroProblem(**AP)
    solver(ap)
    funcs = solver.evalFunctions(ap, {})
    return jax_solver, jax_funcs, solver, funcs


def test_rk_history_matches(both_solves):
    jax_solver, _, solver, _ = both_solves
    hj, ht = jax_solver.solve_info.history, solver.solve_info.history
    assert hj.shape == ht.shape == (25, 2)
    assert solver.solve_info.iterations == jax_solver.solve_info.iterations
    assert np.all(np.isfinite(ht))
    # the residual moved: the solve did work
    assert ht[-1, 0] < ht[0, 0]
    for c in range(2):
        assert _rel(hj[:, c], ht[:, c]) < TOL, c


def test_final_states_match(both_solves):
    jax_solver, _, solver, _ = both_solves
    sj = np.asarray(jax_solver.getStates()).reshape(-1, 6)
    st = solver.getStates().numpy().reshape(-1, 6)
    assert solver.getStates().dtype == torch.float64
    for c in range(6):
        assert _rel(sj[:, c], st[:, c]) < TOL, c


def test_eval_functions_match(both_solves):
    _, jax_funcs, _, funcs = both_solves
    for key in ("m6_cl", "m6_cd"):
        assert np.isfinite(funcs[key])
        assert abs(funcs[key] - jax_funcs[key]) <= TOL * abs(jax_funcs[key])


def test_set_states_round_trip(both_solves):
    """setStates takes the JAX package's state as a numpy vector; the port's
    residual of that state equals the JAX package's."""
    jax_solver, _, solver, _ = both_solves
    solver.setStates(np.asarray(jax_solver.getStates()))
    rj = jax_solver.getResidual(jax_solver.curAP)
    rt = solver.getResidual(solver.curAP)
    for c in range(6):
        assert _rel(np.asarray(rj[0])[..., c], rt[0][..., c].numpy()) < TOL


@pytest.mark.parametrize("kind", ["offset", "rotate"])
def test_inf_change_correction_matches(kind):
    """Switching to a new free stream corrects the stored state the same
    way in both packages (setAeroProblem -> _inf_change_correction)."""
    opts = dict(OPTS, infChangeCorrectionType=kind)
    jax_solver = JaxADFLOW(options=opts,
                           mesh=jax_wing(ni=8, nj=4, nk=4, viscous=True))
    solver = ADFLOW(options=opts,
                    mesh=wing_omesh(ni=8, nj=4, nk=4, viscous=True),
                    device="cpu")
    second = dict(AP, name="second", mach=0.7, alpha=5.0)
    for s, ap_cls in ((jax_solver, JaxAP), (solver, AeroProblem)):
        s.setAeroProblem(ap_cls(**AP))
        s.setStates(np.asarray(s.getStates()) * 1.01)
        s._before = np.asarray(s.getStates())
        # same name: the stored state carries over and is corrected
        s.setAeroProblem(ap_cls(**dict(second, name=AP["name"])))
    sj = np.asarray(jax_solver.getStates())
    st = solver.getStates().numpy()
    assert _rel(sj, st) < 1e-13
    assert _rel(solver._before, st) > 1e-3


def test_default_device_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: ADFLOW() runs on cuda:0")
    with pytest.raises(RuntimeError, match="cuda"):
        ADFLOW(options=OPTS, mesh=wing_omesh(ni=8, nj=4, nk=4, viscous=True))


@pytest.mark.parametrize("branch,opts", [
    ("ank", {"useANKSolver": True}),
    ("nk", {"useNKSolver": True}),
    ("unsteady", {"equationMode": "unsteady"}),
    ("multigrid", {"MGCycle": "2w"}),
])
def test_unported_branches_raise(branch, opts):
    solver = ADFLOW(options=dict(OPTS, **opts),
                    mesh=wing_omesh(ni=8, nj=4, nk=4, viscous=True),
                    device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        solver(AeroProblem(**AP))


def test_port_imports_no_jax():
    code = ("import sys, adflow_torch.api.solver, adflow_torch.interop, "
            "adflow_torch.ops.cuda_rans; "
            "bad = [m for m in sys.modules "
            "if m.split('.')[0] in ('jax', 'jaxlib', 'adflow_tpu')]; "
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], check=True)
