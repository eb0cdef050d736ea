"""The port's run control and integrations, float64 on the CPU:

- SIGUSR2 during a solve (sent from the iteration monitor, so the test is
  deterministic) writes the current iterate to ``<name>_sig`` files and
  stops the solve after that iteration, by RK and by ANK; the handlers
  are restored afterwards (tests/test_signals.py);
- ``jaxProfileDir`` (the option keeps its name) leaves a non-empty
  ``torch.profiler`` trace that holds the solve's spans;
- ``utils/performance.py`` against the JAX package's functions on the
  cases of tests/test_performance.py;
- the MPhys components through the ``tests/miniom.py`` stub on the small
  wing: the solver component's fwd/rev dot-product identity to 1e-10
  (tests/test_mphys_components.py), and its residual, functions and
  forces equal to the JAX package's adapter to 1e-12.
"""

import glob
import json
import os
import signal

import numpy as np
import pytest

from adflow_torch.api import solver as tsolver
from tests import torch_pairs
from tests.miniom import install_stub

install_stub()

from adflow_torch.integrations.mphys import ADflowBuilder  # noqa: E402
from adflow_tpu.integrations.mphys import (  # noqa: E402
    ImplicitCFDAdapter as JaxAdapter)

WING = dict(ni=16, nj=8, nk=8)
AP = dict(name="sig", mach=0.84, alpha=3.06, evalFuncs=["cl", "cd"])


@pytest.mark.parametrize("kind, per_poll", [("RK", 25), ("ANK", 1)])
def test_sigusr2_writes_and_stops(tmp_path, monkeypatch, kind, per_poll):
    """The monitor sends SIGUSR2 at its first row; the solve polls after
    that RK chunk or before the next ANK step, writes and stops."""
    from adflow_torch.core.refstate import AeroProblem
    from adflow_torch.meshgen.analytic import wing_omesh

    sent = []
    row = tsolver._IterMonitor.__call__

    def monitor_row(self, it, *args, **kwargs):
        row(self, it, *args, **kwargs)
        if not sent:
            sent.append(it)
            os.kill(os.getpid(), signal.SIGUSR2)

    monkeypatch.setattr(tsolver._IterMonitor, "__call__", monitor_row)
    before = signal.getsignal(signal.SIGUSR2)
    s = tsolver.ADFLOW(options={
        "equationType": "euler", "useANKSolver": kind == "ANK",
        "ANKSwitchTol": 10.0, "nCycles": 2000, "L2Convergence": 1e-14,
        "printIterations": True, "printTiming": False,
        "outputDirectory": str(tmp_path)}, mesh=wing_omesh(**WING),
        device="cpu")
    s(AeroProblem(**AP))
    assert s.solve_info.iterations == per_poll == sent[0]
    written = sorted(os.path.basename(f)
                     for f in glob.glob(str(tmp_path / "*_sig*")))
    assert written == ["sig_sig_000_surf.dat", "sig_sig_000_vol.cgns"]
    assert signal.getsignal(signal.SIGUSR2) is before
    # the file holds the iterate the solve stopped at
    from adflow_torch.io.cgns import read_cgns_solution
    rho = read_cgns_solution(str(tmp_path / "sig_sig_000_vol.cgns"))[0]
    np.testing.assert_array_equal(
        rho["Density"], s.w_list[0][2:-2, 2:-2, 2:-2, 0].numpy())


def test_profile_dir(tmp_path):
    from adflow_torch.core.refstate import AeroProblem
    from adflow_torch.meshgen.analytic import wing_omesh

    trace_dir = tmp_path / "trace"
    s = tsolver.ADFLOW(options={
        "equationType": "euler", "useANKSolver": True, "nCycles": 1,
        "jaxProfileDir": str(trace_dir), **torch_pairs.QUIET},
        mesh=wing_omesh(**WING), device="cpu")
    s(AeroProblem(**AP))
    traces = glob.glob(str(trace_dir / "*.pt.trace.json"))
    assert len(traces) == 1 and os.path.getsize(traces[0]) > 0
    # the solve's spans (utils/trace.py) are in the trace
    with open(traces[0]) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"newton.step", "krylov.matvec", "halo.fill"} <= names


PERF_CASES = [
    ("short_period_frequency_damping", dict(
        cmq=-2.0, clalpha=5.0, cd=0.02, cmalpha=-1.5, cmalphadot=-1.0,
        mass=1e4, Iy=1e5, rho=1.0, area=20.0, U=100.0, chord=2.0)),
    ("n_alpha", dict(clalpha=5.0, rho=1.0, area=20.0, U=100.0, mass=1e4)),
    ("control_anticipation_parameter", dict(wsp=2.0, nalpha=5.1)),
    ("thumbnail_constraint", dict(wn=3.01, damping_ratio=0.76)),
    ("thumbnail_constraint", dict(wn=20.0, damping_ratio=0.76)),
    ("thumbnail_constraint", dict(wn=0.2, damping_ratio=0.05)),
    ("handling_qualities", dict(
        ts_stab={"clalpha": 5.5, "cmzalpha": -1.2, "cmzalphadot": -3.0},
        mass=5e4, Iy=3e6, rho=0.41, area=120.0, U=230.0, chord=5.0,
        cd=0.025)),
]


@pytest.mark.parametrize("name, kwargs", PERF_CASES)
def test_performance(name, kwargs):
    from adflow_torch.utils import performance as tperf
    from adflow_tpu.utils import performance as jperf
    assert getattr(tperf, name)(**kwargs) == getattr(jperf, name)(**kwargs)


def test_performance_unstable_raises():
    from adflow_torch.utils.performance import (
        short_period_frequency_damping)
    with pytest.raises(ValueError, match="unstable"):
        short_period_frequency_damping(
            cmq=0.0, clalpha=0.0, cd=0.0, cmalpha=3.0, cmalphadot=0.0,
            mass=1e4, Iy=1e5, rho=1.0, area=20.0, U=100.0, chord=2.0)


# -- MPhys --------------------------------------------------------------------

@pytest.fixture(scope="module")
def mphys():
    """The port's MPhys builder and components and the JAX package's adapter,
    at the wing's seeded perturbed free stream."""
    from adflow_torch.core.refstate import AeroProblem
    from adflow_torch.meshgen.analytic import wing_omesh

    js, _ = torch_pairs.solvers("euler_wing")
    w0 = torch_pairs.perturbed(np.asarray(js.getStates()), 5)
    js.setStates(w0)
    ap = AeroProblem(**dict(AP, name="w"))
    b = ADflowBuilder({"equationType": "euler", **torch_pairs.QUIET},
                      mesh=wing_omesh(**WING), device="cpu")
    b.initialize()
    solver = b.get_coupling_group_subsystem()(ap=ap).setup_run()
    solver.outputs["adflow_states"] = w0.copy()
    return b, ap, solver, JaxAdapter(js, js.curAP), w0


def test_mphys_mesh_component(mphys):
    b = mphys[0]
    comp = b.get_mesh_coordinate_subsystem()().setup_run()
    comp.compute(comp.inputs, comp.outputs)
    np.testing.assert_array_equal(comp.outputs["adflow_vol_coords"],
                                  b.solver.getGrid())
    assert b.get_number_of_nodes() * 3 == b.solver.getGrid().size


def test_mphys_residual_and_functions(mphys):
    b, ap, solver, jax_adapter, w0 = mphys
    solver.apply_nonlinear(solver.inputs, solver.outputs, solver.residuals)
    want = jax_adapter.apply_nonlinear()
    got = solver.residuals["adflow_states"]
    scale = torch_pairs.flux_scale(b.solver._filled_w()[0],
                                   b.solver.metrics_list[0])
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12 * scale)
    np.testing.assert_array_equal(solver.adapter.get_states(), w0)

    funcs = b.get_post_coupling_subsystem()(ap=ap).setup_run()
    funcs.inputs["adflow_states"] = w0.copy()
    funcs.compute(funcs.inputs, funcs.outputs)
    fj = jax_adapter.eval_functions(["cl", "cd"])
    for f in ("cl", "cd"):
        assert abs(float(funcs.outputs[f]) - fj[f]) <= 1e-12 * abs(fj[f])

    forces = b.get_forces_subsystem()(ap=ap).setup_run()
    forces.inputs["adflow_states"] = w0.copy()
    forces.compute(forces.inputs, forces.outputs)
    fw = np.asarray(jax_adapter.solver.getForces()).reshape(-1)
    np.testing.assert_allclose(forces.outputs["f_aero"], fw, rtol=0,
                               atol=1e-12 * np.abs(fw).max())


def test_mphys_linear_dot_products(mphys):
    """<J v, u> = <v, J^T u> through apply_linear, and the functions
    component's fwd and rev jacvec products, to 1e-10."""
    b, ap, solver, _, w0 = mphys
    solver.apply_nonlinear(solver.inputs, solver.outputs, solver.residuals)
    rng = np.random.default_rng(3)
    n = w0.size
    nx = solver.inputs["adflow_vol_coords"].size
    vw, vx, u = (rng.standard_normal(n), rng.standard_normal(nx),
                 rng.standard_normal(n))
    d_res = {"adflow_states": np.zeros(n)}
    solver.apply_linear(solver.inputs, solver.outputs,
                        {"adflow_vol_coords": vx.copy()},
                        {"adflow_states": vw.copy()}, d_res, "fwd")
    fwd = float(np.dot(d_res["adflow_states"], u))
    d_in = {"adflow_vol_coords": np.zeros(nx)}
    d_out = {"adflow_states": np.zeros(n)}
    solver.apply_linear(solver.inputs, solver.outputs, d_in, d_out,
                        {"adflow_states": u.copy()}, "rev")
    rev = float(np.dot(d_out["adflow_states"], vw)
                + np.dot(d_in["adflow_vol_coords"], vx))
    assert abs(fwd - rev) <= 1e-10 * abs(fwd)

    funcs = b.get_post_coupling_subsystem()(ap=ap).setup_run()
    funcs.inputs["adflow_states"] = w0.copy()
    funcs.compute(funcs.inputs, funcs.outputs)
    d_in = {"adflow_states": vw.copy(),
            "adflow_vol_coords": np.zeros(nx)}
    d_out = {"cl": np.zeros(1), "cd": np.zeros(1)}
    funcs.compute_jacvec_product(funcs.inputs, d_in, d_out, "fwd")
    d_in2 = {"adflow_states": np.zeros(n), "adflow_vol_coords": np.zeros(nx)}
    funcs.compute_jacvec_product(funcs.inputs, d_in2, {"cl": np.ones(1)},
                                 "rev")
    rev_cl = float(np.dot(d_in2["adflow_states"], vw))
    assert abs(float(d_out["cl"][0]) - rev_cl) <= 1e-10 * abs(rev_cl)
