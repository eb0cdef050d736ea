"""Port parity for the steady RANS-SA Runge-Kutta solve (the ANK solve is in
tests/test_torch_ank_solve.py).

Both packages run ``ADFLOW`` on ``wing_omesh(16, 8, 8, viscous=True)`` with
RANS, ``useANKSolver=False`` and 25 RK cycles in float64 on the CPU. The
residual history, the final interior states and ``evalFunctions`` cl/cd
agree to 1e-9 relative. The port refuses to start without a card unless the
caller names a device, and none of its modules imports JAX or the JAX
package. Each physics option and an actuator region run through
``ADFLOW``, and so do the solver branches that ROADMAP.md item 10 ported
(the multigrid ANK preconditioner, the unsteady mode, multigrid), against
the JAX package; what still raises names its ROADMAP.md item (12, 13).
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
from adflow_torch.meshgen.analytic import flatplate_mesh, wing_omesh
from tests.torch_pairs import perturbed

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
    pytest.param("ank", {"useANKSolver": True, "nCycles": 2,
                         "ANKGlobalPreconditioner": "multigrid"},
                 marks=pytest.mark.slow),
    ("unsteady", {"equationType": "euler", "equationMode": "unsteady",
                  "deltaT": 1e-4, "timeIntegrationScheme": "explicit RK"}),
    pytest.param("multigrid", {"equationType": "euler", "MGCycle": "3w",
                               "nCycles": 5, "nCyclesCoarse": 25,
                               "CFLCoarse": 0.25},
                 marks=pytest.mark.slow),
])
def test_ported_branches_match_jax(branch, opts):
    """The branches of ``__call__`` that the port once refused run through
    ``ADFLOW`` as in the JAX package, from the seeded perturbed free
    stream (tests/torch_pairs.py): the multigrid (AMG) ANK preconditioner
    (2 steps of the 8x4x4 RANS-SA wing), the unsteady mode (2 explicit RK4
    steps of the 16x8x8 Euler wing; BDF and the pieces are in
    tests/test_torch_unsteady.py) and a '3w' multigrid solve of the Euler
    wing with its full-multigrid start (5 cycles; the start replaces the
    perturbed state). History, states and cl/cd to 1e-9. The ANK and
    multigrid cases are slow: the JAX package compiles their steps and
    cycles (1 to 5 min)."""
    if branch == "ank":
        jax_mesh = jax_wing(ni=8, nj=4, nk=4, viscous=True)
        mesh = wing_omesh(ni=8, nj=4, nk=4, viscous=True)
        ap_kw = AP
    else:
        jax_mesh, mesh = jax_wing(ni=16, nj=8, nk=8), wing_omesh(ni=16, nj=8,
                                                              nk=8)
        ap_kw = dict(name="w", mach=0.84, alpha=3.06, evalFuncs=["cl", "cd"])
    jax_solver = JaxADFLOW(options=dict(OPTS, **opts), mesh=jax_mesh)
    solver = ADFLOW(options=dict(OPTS, **opts), mesh=mesh, device="cpu")
    jax_ap, ap = JaxAP(**ap_kw), AeroProblem(**ap_kw)
    # from the seeded perturbed free stream (the sensor kink of the exact
    # one, tests/torch_pairs.py)
    jax_solver.setAeroProblem(jax_ap)
    solver.setAeroProblem(ap)
    w0 = perturbed(np.asarray(jax_solver.getStates()), solver.ref.nw)
    jax_solver.setStates(w0)
    solver.setStates(w0)
    jax_solver(jax_ap, nTimeSteps=2)
    solver(ap, nTimeSteps=2)
    if branch == "unsteady":
        hj = jax_solver.unsteady_info.inner_res
        ht = solver.unsteady_info.inner_res
        assert ht.shape == (2,)
    else:
        hj = jax_solver.solve_info.history
        ht = solver.solve_info.history
    assert hj.shape == ht.shape and np.all(np.isfinite(ht))
    assert _rel(hj, ht) < TOL
    assert _rel(np.asarray(jax_solver.getStates()),
                solver.getStates().numpy()) < TOL
    fj = jax_solver.evalFunctions(jax_ap, {})
    ft = solver.evalFunctions(ap, {})
    for key in fj:
        assert abs(ft[key] - fj[key]) <= TOL * abs(fj[key]), key


@pytest.mark.parametrize("option,value,item", [
    ("meshDevices", 2, "12"),
    ("restartFile", "restart.cgns", "13"),
])
def test_unported_options_raise(option, value, item):
    """Both items are ported. Several devices (item 12) take a process
    group of ``meshDevices`` ranks, and without one construction raises
    ValueError. Restart files (item 13): the solver builds, and reading the
    state from a file that does not exist raises FileNotFoundError naming
    it."""
    opts = dict(OPTS, **{option: value})
    mesh = wing_omesh(ni=8, nj=4, nk=4, viscous=True)
    if item == "13":
        solver = ADFLOW(options=opts, mesh=mesh, device="cpu")
        with pytest.raises(FileNotFoundError, match=value):
            solver.setAeroProblem(AeroProblem(name="r", mach=0.5))
        return
    with pytest.raises(ValueError, match=f"meshDevices={value} runs one"):
        ADFLOW(options=opts, mesh=mesh, device="cpu")


PLATE_AP = dict(name="fp", mach=0.3, alpha=0.0, reynolds=1e6,
                reynoldsLength=1.0, T=300.0, evalFuncs=["cd"])


@pytest.mark.parametrize("options,ap_changes", [
    ({"useWallFunctions": True, "useANKSolver": False, "nCycles": 25}, {}),
    ({"turbulenceModel": "SST"}, {}),
    ({"turbulenceModel": "SA-Edwards"}, {}),
    ({"useQCR": True, "useRotationSA": True}, {}),
    ({"turbulenceOrder": "second order"}, {}),
    ({"lowSpeedPreconditioner": True}, {"mach": 0.05}),
    ({}, {"rotRate": (0.0, 0.0, 20.0), "rotCenter": (0.25, 0.0, 0.0)}),
    ({}, {"machGrid": 0.2}),
], ids=["wall functions", "SST", "SA-Edwards", "QCR and rotation-SA",
        "second-order turbulence", "low-speed preconditioner", "rotRate",
        "machGrid"])
def test_physics_options_solve(options, ap_changes):
    """Every physics option of the JAX package's residual runs through
    ``ADFLOW`` on the 16x12 RANS plate: two ANK steps (the wall functions
    25 RK cycles: their jvp is slow on the CPU) and ``evalFunctions``. The
    options' parity with the JAX package is in tests/test_torch_sst.py,
    _sa_variants.py, _wallfn.py, _lowspeed.py and _ale.py."""
    opts = dict(OPTS, useANKSolver=True, nCycles=2, ANKMaxIter=4)
    solver = ADFLOW(options=dict(opts, **options),
                    mesh=flatplate_mesh(ni=16, nj=12), device="cpu")
    ap = AeroProblem(**dict(PLATE_AP, **ap_changes))
    solver(ap)
    funcs = solver.evalFunctions(ap, {})
    info = solver.solve_info
    assert info.iterations == int(solver.options["nCycles"])
    assert not info.failed and np.all(np.isfinite(info.history))
    assert info.history[-1, 0] < info.history[0, 0]
    assert np.isfinite(funcs["fp_cd"])
    if ap_changes.keys() & {"rotRate", "machGrid"}:
        assert solver.metrics_list[0].vfIE is not None


def test_actuator_region_solves():
    """``addActuatorRegion`` on the RANS plate (a disk across the flow
    above the plate), then two ANK steps (parity in
    tests/test_torch_actuator.py)."""
    solver = ADFLOW(options=dict(OPTS, useANKSolver=True, nCycles=2,
                                 ANKMaxIter=4),
                    mesh=flatplate_mesh(ni=16, nj=12), device="cpu")
    ap = AeroProblem(**PLATE_AP)
    solver.setAeroProblem(ap)
    solver.addActuatorRegion([0.4, 0.1, 0.025], [0.5, 0.1, 0.025],
                             radius=0.1, thrust=1e-4)
    src = solver.extras_list[0]["act_src_momentum"]
    assert abs(float(src[..., 1].sum()) - 1e-4) < 1e-16
    solver(ap)
    assert not solver.solve_info.failed
    assert np.all(np.isfinite(solver.solve_info.history))


def test_port_imports_no_jax():
    code = ("import sys, adflow_torch.api.solver, adflow_torch.interop, "
            "adflow_torch.ops.cuda_rans, adflow_torch.ops.cuda_inviscid, "
            "adflow_torch.solvers.newton, adflow_torch.solvers.multigrid, "
            "adflow_torch.solvers.amg, adflow_torch.solvers.unsteady, "
            "adflow_torch.solvers.timespectral; "
            "bad = [m for m in sys.modules "
            "if m.split('.')[0] in ('jax', 'jaxlib', 'adflow_tpu')]; "
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], check=True)
