"""Port parity for the slice as a whole: the default ANK steady solve.

Both packages run ``ADFLOW`` with the default options (ANK on, NK off) in
float64 on the CPU, from the same seeded perturbed state (see
tests/torch_pairs.py for why not the exact free stream): the Euler 16x8x8
wing for 5 steps and the RANS-SA plate for 4; and the Euler wing with NK on,
which hands over from ANK to NK after three steps. The residual history,
the final interior states and ``evalFunctions`` agree to 1e-9 relative:
the wall forces, and on the plate the flow-through functions of its
outflow. The slow tests start the Euler wing from the exact free stream and
hold the port to the JAX package evaluated op by op, and solve the
turbulent plate of tests/test_solve_rans.py to convergence in both
packages (the acceptance case of ROADMAP.md queue 1 item 7).
"""

import numpy as np
import pytest
import torch

from tests.torch_pairs import perturbed, rel, solvers

TOL = 1e-9
# run -> (case, options, the kinds of its steps)
RUNS = {
    "euler_wing": ("euler_wing", {"nCycles": 5}, ["ANK"] * 5),
    "rans_plate": ("rans_plate", {"nCycles": 4}, ["ANK"] * 4),
    "euler_wing_nk": ("euler_wing",
                      {"nCycles": 5, "useNKSolver": True,
                       "NKSwitchTol": 0.3},
                      ["ANK"] * 3 + ["NK"] * 2),
}


# the flow-through functions, where the mesh has inflow or outflow faces
FLOW_FUNCS = ["mdot", "mavgptot", "mavgttot", "mavgps", "mavgmn",
              "aavgptot", "aavgps", "area"]


def _solve(s, w0=None):
    if w0 is not None:
        s.setStates(w0)
    s(s.curAP)
    return (s.solve_info, np.asarray(s.getStates()),
            s.evalFunctions(s.curAP, {}, list(s.curAP.evalFuncs)
                            + FLOW_FUNCS))


@pytest.fixture(scope="module", params=sorted(RUNS))
def both_solves(request):
    case, options, _ = RUNS[request.param]
    js, ts = solvers(case, **options)
    w0 = perturbed(js.getStates(), js.ref.nw)
    return request.param, _solve(js, w0), _solve(ts, w0)


def test_history_matches(both_solves):
    run, (info_j, _, _), (info_t, _, _) = both_solves
    n = len(RUNS[run][2])
    assert info_t.history.shape == info_j.history.shape == (n, 2)
    assert info_t.iterations == info_j.iterations == n
    assert info_t.failed == info_j.failed is False
    assert np.all(np.isfinite(info_t.history))
    assert info_t.history[-1, 0] < info_t.history[0, 0]
    assert rel(info_j.history, info_t.history) < TOL


def test_final_states_match(both_solves):
    _, (_, sj, _), (_, st, _) = both_solves
    assert rel(sj, st) < TOL


def test_functions_match(both_solves):
    run, (_, _, fj), (_, _, ft) = both_solves
    assert fj.keys() == ft.keys() and fj
    # the plate's outflow plane: every flow-through function
    assert ("fp_mdot" in ft) == (run == "rans_plate")
    assert len(ft) == (9 if run == "rans_plate" else 3)
    for key in fj:
        assert np.isfinite(ft[key])
        assert abs(ft[key] - fj[key]) <= TOL * abs(fj[key]), key


def test_step_records(both_solves):
    """The port's per-step records: one per iteration, each with its stats
    (7 for ANK, 5 for NK), the CFL it ran at (None for NK) and its residual
    evaluations: the residual, one per Krylov matvec, the merits (three for
    a coupled ANK step, five for NK's line search) and the new residual."""
    run, _, (info, _, _) = both_solves
    assert [r.kind for r in info.steps] == RUNS[run][2]
    for r in info.steps:
        ank = r.kind == "ANK"
        assert r.stats.shape == ((7,) if ank else (5,)) and r.seconds > 0.0
        assert r.res_evals == 1 + r.krylov_matvecs + (3 if ank else 5) + 1
        assert r.krylov_matvecs > r.stats[4 if ank else 3] >= 1
        assert (r.cfl is None) == (not ank)
    assert info.steps[0].cfl == 5.0     # ANKCFL0
    assert [r.stats[1] for r in info.steps] == list(info.history[:, 0])


@pytest.mark.slow
def test_ank_free_stream_matches_eager_jax():
    """From the exact free stream the JAX package's XLA-compiled step and
    its op-by-op evaluation differ (the sensor kink, tests/torch_pairs.py);
    the port agrees with the op-by-op one. Slow: the JAX package solves
    without compiling its steps."""
    import jax

    js, ts = solvers("euler_wing", nCycles=5)
    with jax.disable_jit():
        info_j, sj, fj = _solve(js)
    info_t, st, ft = _solve(ts)
    assert rel(info_j.history, info_t.history) < TOL
    assert rel(sj, st) < TOL
    for key in fj:
        assert abs(ft[key] - fj[key]) <= TOL * abs(fj[key]), key
    assert ts.getStates().dtype == torch.float64


@pytest.mark.slow
def test_turbulent_plate_acceptance():
    """The turbulent flat plate of tests/test_solve_rans.py (48x48, M 0.2,
    Re 2e6) solved to L2Convergence 1e-7 by both packages: cl, cd and the
    flow-through functions agree to 1e-6 relative (the two converge to the
    same discrete solution, not along the same path), and the port's
    mid-plate cf is within 15% of the 0.0576 Re_x^-1/5 correlation. Slow:
    about 150 pseudo-time steps in each package."""
    from adflow_torch.api.solver import ADFLOW
    from adflow_torch.core.refstate import AeroProblem
    from adflow_torch.meshgen.analytic import flatplate_mesh
    from adflow_tpu.api.solver import ADFLOW as JaxADFLOW
    from adflow_tpu.core.refstate import AeroProblem as JaxAP
    from adflow_tpu.meshgen.analytic import flatplate_mesh as jax_plate

    opts = {"equationType": "RANS", "ANKSwitchTol": 1.5,
            "L2Convergence": 1e-7, "printIterations": False,
            "printTiming": False, "nCycles": 150}
    ap = dict(name="tplate", mach=0.2, reynolds=2e6, reynoldsLength=1.0,
              T=288.15)
    mesh = dict(ni=48, nj=48, wall_spacing=2e-5, height=0.5)
    names = ["cl", "cd"] + FLOW_FUNCS
    funcs = []
    for solver_cls, ap_cls, gen, kw in (
            (JaxADFLOW, JaxAP, jax_plate, {}),
            (ADFLOW, AeroProblem, flatplate_mesh, {"device": "cpu"})):
        s = solver_cls(options=opts, mesh=gen(**mesh), **kw)
        s(ap_cls(**ap))
        info = s.solve_info
        assert info.converged and info.total_r_final < 1e-7 * info.total_r0
        funcs.append(s.evalFunctions(s.curAP, {}, names))
    fj, ft = funcs
    assert fj.keys() == ft.keys() and len(ft) == len(names)
    for key in fj:
        assert abs(ft[key] - fj[key]) <= 1e-6 * abs(fj[key]), key

    # mid-plate cf from the first cell off the wall (test_solve_rans.py)
    wf = s._filled_w()[0]
    xc = s.metrics_list[0].xc_ext[1:-1, 1:-1, 1:-1].numpy()
    wi = wf[2:-2, 2:-2, 2:-2].numpy()
    i_x = int(np.argmin(np.abs(xc[:, 0, 0, 0] - 0.5)))
    u1 = wi[i_x, 0, 0, 1] / wi[i_x, 0, 0, 0]
    cf = s.ref.mu_inf * u1 / xc[i_x, 0, 0, 1] / (0.5 * 0.2 ** 2)
    cf_corr = 0.0576 * (0.2 * xc[i_x, 0, 0, 0] / s.ref.mu_inf) ** -0.2
    assert abs(cf / cf_corr - 1.0) < 0.15
