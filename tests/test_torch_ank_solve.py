"""Port parity for the slice as a whole: the default ANK steady solve.

Both packages run ``ADFLOW`` with the default options (ANK on, NK off) in
float64 on the CPU, from the same seeded perturbed state (see
tests/torch_pairs.py for why not the exact free stream): the Euler 16x8x8
wing for 5 steps and the RANS-SA plate for 4; and the Euler wing with NK on,
which hands over from ANK to NK after three steps. The residual history,
the final interior states and ``evalFunctions`` agree to 1e-9 relative; the
plate's functions are the wall forces only, as the port does not integrate
flow-through faces yet (ROADMAP.md queue 1 item 7). The slow test starts the
Euler wing from the exact free stream and holds the port to the JAX package
evaluated op by op.
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


def _solve(s, w0=None):
    if w0 is not None:
        s.setStates(w0)
    s(s.curAP)
    # wall forces only (see the module docstring)
    s.flow_patches = []
    return (s.solve_info, np.asarray(s.getStates()),
            s.evalFunctions(s.curAP, {}))


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
    _, (_, _, fj), (_, _, ft) = both_solves
    assert fj.keys() == ft.keys() and fj
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
