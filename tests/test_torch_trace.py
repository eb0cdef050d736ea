"""The tracer of the port's solve loops (``adflow_torch/utils/trace.py``),
on the CPU in float64, on the 16x8x8 wing:

- no span is recorded without a profiler, and the buffer keeps the latest
  profiler session's spans up to its cap, counting what it drops;
- under a CPU-activity ``torch.profiler``, an ANK solve records the tree
  api.solve > newton.step > krylov.gmres > krylov.iter > krylov.matvec /
  krylov.precond, every child inside its parent, one request id; each
  step's ``krylov.matvec`` spans number its ``StepRecord.krylov_matvecs``
  and its span agrees with its ``StepRecord.seconds``;
- ``host_syncs`` counts the copies the sites make: one for ||b||, one a
  restart cycle and one an Arnoldi column in GMRES, three an ANK step
  (its stats and the line search's two reads of its argmin) and two at
  the Newton driver's start, one a chunk of RK cycles;
- spans inside ``torch.func.jvp`` (the matvec's halo fills);
- an RK solve: 6 ``halo.fill`` and 12 ``halo.bc_pass`` a
  ``smoother.cycle``;
- an adjoint: its ``krylov.matvec`` spans number ``GmresResult.matvecs``,
  one ``adjoint.pc_build`` a solve;
- the solve's states and ``SolveInfo`` bitwise equal with the profiler on
  and off;
- ``bc_launches``, the BC pass kernel's launches (run here by its CPU twin,
  ``tests/torch_bc_twin.py``): 4 a ``halo.bc_pass`` on the wing
  (one a physical subface), 8 under a jvp (the forward's and the
  tangent's), 0 where autograd records; in an ANK solve and its adjoint,
  every pass under ``newton.step`` launches and none under
  ``adjoint.solve``.

On a card (marker ``cuda``, skipped without one): under a CPU+CUDA
profile, the spans and the device's events are on one clock: every K2
launch (``cudaLaunchKernel``) lies inside a span of the solve, one inside
each ``krylov.matvec`` of the steps, and its kernel starts after that
span starts. The file imports no JAX, so the card test runs on a machine
without it: ``python -m pytest tests/test_torch_trace.py -m cuda
--noconftest``.
"""

import collections

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from adflow_torch import ADFLOW, AeroProblem
from adflow_torch.meshgen.analytic import wing_omesh
from adflow_torch.ops import cuda_bc
from adflow_torch.physics import bc
from adflow_torch.physics.residual import fill_halos
from adflow_torch.solvers.krylov import gmres
from adflow_torch.utils import trace
from torch_bc_twin import twin_launch

WING = dict(ni=16, nj=8, nk=8)
QUIET = {"printIterations": False, "printTiming": False}
ANK = {"equationType": "euler", "useANKSolver": True, "useNKSolver": False,
       "nCycles": 3, **QUIET}


def cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def solver_and_start(options, device="cpu"):
    """The wing's solver with its aero problem set, and a seeded start 1e-3
    off the free stream (the exact free stream sits on the JST sensor's
    kink)."""
    s = ADFLOW(options=options, mesh=wing_omesh(**WING), device=device)
    ap = AeroProblem(name="tr", mach=0.84, alpha=3.06,
                     evalFuncs=["cl", "cd"])
    s.setAeroProblem(ap)
    w = s.getStates()
    noise = np.random.default_rng(3).standard_normal(w.shape)
    w = w + 1e-3 * w.abs().max() * torch.as_tensor(noise, dtype=w.dtype,
                                                   device=w.device)
    return s, ap, w


def children(spans):
    out = collections.defaultdict(list)
    for s in spans:
        out[s.parent].append(s)
    return out


def descendants(spans, top, name):
    kids = children(spans)
    found, todo = [], list(kids[top.id])
    while todo:
        s = todo.pop()
        found += [s] if s.name == name else []
        todo += kids[s.id]
    return found


def assert_nested(spans):
    """Every child inside its parent, the children's time within the
    parent's, one request id a root."""
    by_id = {s.id: s for s in spans}
    for pid, kids in children(spans).items():
        if pid == 0:
            continue
        p = by_id[pid]
        for c in kids:
            assert p.start_ns <= c.start_ns <= c.end_ns <= p.end_ns
            assert c.root == p.root
        assert sum(c.end_ns - c.start_ns for c in kids) <= \
            p.end_ns - p.start_ns


def small_system(n=40, seed=0):
    rng = np.random.default_rng(seed)
    a = torch.as_tensor(np.eye(n) * 4.0 + rng.standard_normal((n, n)) * 0.3)
    b = torch.as_tensor(rng.standard_normal(n))
    return a, b


@pytest.fixture(scope="module")
def ank():
    """One ANK solve without a profiler and the same solve under one."""
    s, ap, w0 = solver_and_start(ANK)
    s.setStates(w0)
    s(ap)
    off = (s.solve_info, [w.clone() for w in s.w_list])
    with cpu_profile():
        s.setStates(w0)
        s(ap)
    return dict(off=off, info=s.solve_info, w_list=s.w_list,
                spans=trace.spans())


def test_no_spans_without_a_profiler(monkeypatch):
    a, b = small_system()
    gmres(lambda v: a @ v, b, m=5, restarts=3, tol=1e-12)
    with cpu_profile():
        sol = gmres(lambda v: a @ v, b, m=5, restarts=3, tol=1e-12)
    kept = trace.spans()
    names = collections.Counter(s.name for s in kept)
    # a restart cycle's b - A x and its update, an iteration's PC and
    # matvec
    assert names == {"krylov.gmres": 1, "krylov.iter": sol.iters,
                     "krylov.matvec": sol.matvecs,
                     "krylov.precond": sol.matvecs}
    with trace.span("api.solve") as sp:
        assert sp is None
    gmres(lambda v: a @ v, b, m=5, restarts=3, tol=1e-12)
    assert trace.spans() == kept
    # the cap: what does not fit is counted, and the next session starts
    # from an empty buffer
    monkeypatch.setattr(trace, "CAP", 3)
    with cpu_profile():
        gmres(lambda v: a @ v, b, m=5, restarts=3, tol=1e-12)
    assert len(trace.spans()) == 3 and trace.dropped == len(kept) - 3


def test_gmres_counts_its_host_copies():
    a, b = small_system(seed=1)
    n0 = trace.host_syncs
    sol = gmres(lambda v: a @ v, b, m=4, restarts=4, tol=1e-12)
    # ||b||, then beta a restart cycle and a column an Arnoldi iteration
    assert trace.host_syncs - n0 == 1 + sol.matvecs


def test_ank_solve_records_the_tree(ank):
    spans, info = ank["spans"], ank["info"]
    assert_nested(spans)
    by_id = {s.id: s for s in spans}
    (solve,) = [s for s in spans if s.name == "api.solve"]
    assert solve.parent == 0
    assert {s.root for s in spans if s.name != "api.set_states"} == \
        {solve.id}
    parent = {s.name: set() for s in spans}
    for s in spans:
        parent[s.name].add(by_id[s.parent].name if s.parent else None)
    assert parent["newton.step"] == {"api.solve"}
    assert parent["newton.pc_build"] == {"newton.step"}
    assert parent["krylov.gmres"] == {"newton.step"}
    assert parent["krylov.iter"] == {"krylov.gmres"}
    assert parent["krylov.matvec"] == {"krylov.gmres", "krylov.iter"}
    assert parent["krylov.precond"] == {"krylov.gmres", "krylov.iter"}
    steps = [s for s in spans if s.name == "newton.step"]
    assert len(steps) == len(info.steps) == 3


def test_step_spans_match_the_step_records(ank):
    spans, info = ank["spans"], ank["info"]
    steps = sorted((s for s in spans if s.name == "newton.step"),
                   key=lambda s: s.start_ns)
    for sp, rec in zip(steps, info.steps):
        assert len(descendants(spans, sp, "krylov.matvec")) == \
            rec.krylov_matvecs
        assert len(descendants(spans, sp, "krylov.iter")) == \
            int(rec.stats[4])
        assert sp.count("res_evals") == rec.res_evals
        assert abs(sp.seconds - rec.seconds) <= 0.02 * rec.seconds
        # the step's stats, the line search's two reads of its argmin, and
        # ||b||, beta and a column in its GMRES
        assert sp.count("host_syncs") == 4 + rec.krylov_matvecs
    (solve,) = [s for s in spans if s.name == "api.solve"]
    # and the driver's two starting norms
    assert solve.count("host_syncs") == 2 + sum(
        4 + r.krylov_matvecs for r in info.steps)


def test_spans_inside_jvp(ank):
    spans = ank["spans"]
    for mv in (s for s in spans if s.name == "krylov.matvec"):
        fills = descendants(spans, mv, "halo.fill")
        assert len(fills) == 1
        assert len(descendants(spans, mv, "halo.bc_pass")) == 2
    s, _, w0 = solver_and_start(ANK)
    s.setStates(w0)
    v = [torch.ones_like(w) for w in s.w_list]

    def fill(*w_list):
        return tuple(fill_halos(list(w_list), s.metrics_list, s.topo, s.ref,
                                s.winf))
    want = torch.func.jvp(fill, tuple(s.w_list), tuple(v))
    with cpu_profile():
        got = torch.func.jvp(fill, tuple(s.w_list), tuple(v))
    names = collections.Counter(x.name for x in trace.spans())
    assert names == {"halo.fill": 1, "halo.bc_pass": 2}
    for a, b in zip(want[0] + want[1], got[0] + got[1]):
        assert torch.equal(a, b)


def test_profiler_changes_no_number(ank):
    info_off, w_off = ank["off"]
    info = ank["info"]
    for a, b in zip(w_off, ank["w_list"]):
        assert torch.equal(a, b)
    assert info._replace(steps=(), history=None) == \
        info_off._replace(steps=(), history=None)
    np.testing.assert_array_equal(info.history, info_off.history)
    for a, b in zip(info.steps, info_off.steps):
        np.testing.assert_array_equal(a.stats, b.stats)
        assert a._replace(stats=None, seconds=0.0) == \
            b._replace(stats=None, seconds=0.0)


def test_rk_cycle_fills_six_times():
    s, ap, w0 = solver_and_start({"equationType": "euler",
                                  "useANKSolver": False, "nCycles": 25,
                                  **QUIET})
    s.setStates(w0)
    s(ap)
    n0 = trace.host_syncs
    with cpu_profile():
        s.setStates(w0)
        s(ap)
    spans = trace.spans()
    assert_nested(spans)
    cycles = [x for x in spans if x.name == "smoother.cycle"]
    assert len(cycles) == s.solve_info.iterations == 25
    for c in cycles:
        assert len(descendants(spans, c, "halo.fill")) == 6
        assert len(descendants(spans, c, "halo.bc_pass")) == 12
    # one copy of the norms' history a chunk of 25 cycles
    assert trace.host_syncs - n0 == 1


def test_adjoint_matvecs_match_gmres():
    opts = dict(ANK, nCycles=1, adjointMaxIter=8, adjointSubspaceSize=8,
                restartAdjoint=False)
    s, ap, w0 = solver_and_start(opts)
    s.setStates(w0)
    s(ap)
    s.evalFunctionsSens(ap, {}, ["cl"])
    with cpu_profile():
        s.evalFunctionsSens(ap, {}, ["cl"])
    spans = trace.spans()
    assert_nested(spans)
    (root,) = [x for x in spans if x.parent == 0]
    assert root.name == "api.eval_functions_sens"
    (solve,) = [x for x in spans if x.name == "adjoint.solve"]
    assert len(descendants(spans, solve, "krylov.matvec")) == \
        s.adjoint_info.matvecs
    assert len(descendants(spans, solve, "krylov.iter")) == \
        s.adjoint_info.iters
    assert len(descendants(spans, solve, "adjoint.pc_build")) == 1


def on_twin(monkeypatch, ref):
    """Let the float64 CPU states take the BC kernel pass, run by its twin
    (the kernel's operand checks, which take float32, left out)."""
    monkeypatch.setattr(bc, "_kernel_state",
                        lambda w: w.dtype == torch.float64)
    monkeypatch.setattr(cuda_bc, "check_operands", lambda *a: None)
    monkeypatch.setattr(cuda_bc, "_launch", twin_launch(ref))


@pytest.mark.parametrize("mode,per_pass", [("pass", 4), ("jvp", 8),
                                           ("vjp", 0)])
def test_bc_launches_in_the_pass_spans(monkeypatch, mode, per_pass):
    s, _, w0 = solver_and_start(ANK)
    s.setStates(w0)
    on_twin(monkeypatch, s.ref)
    w_list = tuple(s.w_list)

    def fill(*w_list):
        return tuple(fill_halos(list(w_list), s.metrics_list, s.topo, s.ref,
                                s.winf))
    n0 = cuda_bc.LAUNCHES
    with cpu_profile():
        if mode == "pass":
            fill(*w_list)
        elif mode == "jvp":
            torch.func.jvp(fill, w_list, tuple(map(torch.ones_like, w_list)))
        else:
            torch.func.vjp(fill, *w_list)
    passes = [x for x in trace.spans() if x.name == "halo.bc_pass"]
    assert [x.count("bc_launches") for x in passes] == [per_pass] * 2
    assert cuda_bc.LAUNCHES - n0 == 2 * per_pass


def test_bc_launches_in_the_solve_spans(monkeypatch):
    """An ANK step and its adjoint with the kernel pass where it applies:
    each BC pass under ``newton.step`` launches one a subface (the
    matvec's jvp twice that); under ``adjoint.solve`` the recorded passes
    of the vjp launch none, and only the transposed PC's build, whose fill
    autograd does not record, launches one a subface."""
    opts = dict(ANK, nCycles=1, adjointMaxIter=4, adjointSubspaceSize=4,
                restartAdjoint=False)
    s, ap, w0 = solver_and_start(opts)
    on_twin(monkeypatch, s.ref)
    with cpu_profile():
        s.setStates(w0)
        s(ap)
        s.evalFunctionsSens(ap, {}, ["cl"])
    spans = trace.spans()
    (step,) = [x for x in spans if x.name == "newton.step"]
    counts = collections.Counter()
    for mv in descendants(spans, step, "krylov.matvec"):
        counts.update(x.count("bc_launches")
                      for x in descendants(spans, mv, "halo.bc_pass"))
    assert set(counts) == {8}
    counts = {x.count("bc_launches")
              for x in descendants(spans, step, "halo.bc_pass")}
    assert counts == {4, 8}
    (solve,) = [x for x in spans if x.name == "adjoint.solve"]
    (build,) = descendants(spans, solve, "adjoint.pc_build")
    in_build = descendants(spans, build, "halo.bc_pass")
    assert [x.count("bc_launches") for x in in_build] == [4, 4]
    recorded = [x for x in descendants(spans, solve, "halo.bc_pass")
                if x not in in_build]
    assert recorded and {x.count("bc_launches") for x in recorded} == {0}
    assert solve.count("bc_launches") == 8


# -- the card -----------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the spans are joined with the "
                    "card's events")
    return "cuda:0"


@pytest.mark.cuda
def test_spans_share_the_profilers_clock_on_card(cuda_device):
    s, ap, w0 = solver_and_start(dict(ANK, nCycles=2, useBlockettes=True),
                                 device=cuda_device)
    s.setStates(w0)
    s(ap)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        s.setStates(w0)
        s(ap)
        torch.cuda.synchronize()
    spans = trace.spans()
    events = list(prof.profiler.kineto_results.events())
    kernels = {e.correlation_id(): e for e in events
               if e.device_type() == torch.autograd.DeviceType.CUDA
               and "inviscid_residual_kernel" in e.name()}
    launches = [e for e in events
                if e.device_type() == torch.autograd.DeviceType.CPU
                and e.name().startswith("cudaLaunchKernel")
                and e.correlation_id() in kernels]
    assert kernels and len(launches) == len(kernels)
    (solve,) = [x for x in spans if x.name == "api.solve"]
    matvecs = [x for x in spans if x.name == "krylov.matvec"]
    inside = collections.Counter()
    for e in launches:
        t0, t1 = e.start_ns(), e.start_ns() + e.duration_ns()
        assert solve.start_ns <= t0 <= t1 <= solve.end_ns
        for mv in matvecs:
            if mv.start_ns <= t0 and t1 <= mv.end_ns:
                inside[mv.id] += 1
                assert kernels[e.correlation_id()].start_ns() >= \
                    mv.start_ns
    # the primal of each matvec's jvp launches K2 once
    assert inside == {mv.id: 1 for mv in matvecs}
