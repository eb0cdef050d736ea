"""The RK iteration as a CUDA graph (``solvers/rk_graph.py``): captured at
the second iteration of each level in a solve and replayed after.

On the CPU:

- the gate, ``rk_graph.graphable``: false for a CPU state, for float64 and
  where autograd records or a ``torch.func`` transform runs, true where
  the kernels' own gates hold (patched to see a card);
- ``Iteration``'s bookkeeping with a stand-in graph whose replay runs the
  captured function again into the capture's outputs: one eager run, one
  capture, replays after; the counters set back after the capture and
  advanced by its deltas at each replay; the forcing copied once a
  ``force``;
- ``solve_rk`` and ``solve_mg`` on the CPU take no graph (0 replays, 0
  captures); with the stand-in graph they return the eager solve's state
  and history exactly, so no graph output is read after a replay has
  overwritten it.

On a card (marker ``cuda``, skipped without one), float32 on the
benchmark's wing at 64x16x16: ``solve_rk`` replayed bitwise equal to eager
on one block and on two; ``rk_smooth`` at each level of a '3w' hierarchy
with forcing, smoothing and 4 iterations; ``solve_mg`` twice through
``ADFLOW`` (the second at another Mach and CFL) with the launch counters
and ``host_syncs`` equal to eager's and one capture a level a solve; the
kernels in the replays seen by the profiler; no synchronising copy in an
iteration: ``python -m pytest tests/test_torch_rk_graph.py -m cuda
--noconftest``.
"""

import json
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

from adflow_torch.ops import cuda_bc, cuda_inviscid, cuda_irs, cuda_rans
from adflow_torch.physics import bc, residual
from adflow_torch.solvers import multigrid as mg
from adflow_torch.solvers import rk_graph, smoothers, steady
from adflow_torch.utils import trace
from benchmark import program

ROOT = Path(__file__).resolve().parents[1]
SMALL = (16, 8, 8)
CARD = (64, 16, 16)


def config(name, **over):
    return dict(json.loads((ROOT / f"benchmark/configs/{name}.json")
                           .read_text()), **over)


def build(name, dims, device, **over):
    """The benchmark's build of configuration ``name`` at ``dims``: the
    solver, its aero problem set, and a start 1e-3 off the free stream."""
    cell = SimpleNamespace(config=config(name, **over), traffic={
        "start": {"perturbation": 1e-3},
        "launches": {"counter": "cuda_rans"}})
    return program.build(SimpleNamespace(cell=cell, seed=5, device=device,
                                         mesh_dims=dims))


def counters():
    return {"k1": cuda_rans.LAUNCHES, "k2": cuda_inviscid.LAUNCHES,
            "bc": cuda_bc.LAUNCHES, "irs": cuda_irs.LAUNCHES,
            "syncs": trace.host_syncs, "its": trace.rk_iterations,
            "replays": trace.rk_graph_replays,
            "captures": trace.rk_graph_captures}


def advanced(before):
    return {k: v - before[k] for k, v in counters().items()}


def rk_solve(s, w_list, n):
    return steady.solve_rk(w_list, s.metrics_list, s.topo, s.cfg, s.ref,
                           s.winf, cfl=1.0, n_cycles=n, chunk=n,
                           extras_list=s.extras_list)


def mg_solve(s, w_list, n, spec="2w", cfl_coarse=0.25):
    levels = s._mg_levels(mg.parse_mg_cycle(spec)[0])
    return mg.solve_mg(w_list, levels, s.cfg, s.ref, s.winf, mg_cycle=spec,
                       cfl=1.0, n_cycles=n, chunk=n, cfl_coarse=cfl_coarse)


def padded(s, start):
    s.setStates(start)
    return list(s.w_list)


def assert_same_solve(a, b):
    (wa, ia), (wb, ib) = a, b
    assert all(torch.equal(x, y) for x, y in zip(wa, wb))
    assert (ia.history == ib.history).all()
    assert ia.iterations == ib.iterations


# -- the CPU ------------------------------------------------------------

@pytest.fixture(scope="module")
def small_rans():
    return build("m6_rans_sa", SMALL, "cpu", precision="float64")


class StandInGraph:
    """A captured graph on the CPU. The capture runs the function once,
    which a capture on the card does not: that run stands for the first
    replay, and each later replay runs it again (it writes into the
    graph's tensors), with the counters set back as a replay leaves
    them."""

    def __init__(self, fn):
        self.fn, self.fresh = fn, True

    def replay(self):
        if self.fresh:
            self.fresh = False
            return
        before = rk_graph._counts()
        self.fn()
        rk_graph._set_counts(before)


def stand_in_graph_of(fn, slot):
    fn()
    return StandInGraph(fn)


def stand_in(monkeypatch):
    """Every RK iteration graphed, with the stand-in graph."""
    monkeypatch.setattr(rk_graph, "_graph_of", stand_in_graph_of)
    monkeypatch.setattr(rk_graph, "graphable", lambda *a, **kw: True)


@pytest.fixture
def card_gates(monkeypatch):
    """The kernels' gates seeing a float32 CPU state as the card's."""
    monkeypatch.setattr(bc, "_kernel_state",
                        lambda w: w.dtype == torch.float32)
    monkeypatch.setattr(residual, "_kernel_applies", lambda *a: True)
    monkeypatch.setattr(smoothers, "_irs_kernel_applies", lambda r: True)


def _gate(s, w_list, winf=None):
    return rk_graph.graphable(w_list, s.metrics_list, s.topo, s.cfg, s.ref,
                              s.winf if winf is None else winf,
                              s.extras_list, irs_eps=0.5)


def _as32(s, w_list):
    return [w.float() for w in w_list], s.winf.float(), [
        type(m)(*(v.float() if torch.is_tensor(v) else v for v in m))
        for m in s.metrics_list]


def test_the_gate_refuses_a_cpu_state(small_rans):
    s = small_rans.solver
    w_list = padded(s, small_rans.start)
    assert not _gate(s, w_list)
    assert not _gate(s, [w.float() for w in w_list], s.winf.float())


@pytest.mark.parametrize("case", ["float64", "recording", "jvp", "card"])
def test_the_gate(small_rans, card_gates, monkeypatch, case):
    """With the kernels' gates seeing a float32 CPU state as the card's,
    the gate holds for a plain float32 state and fails for each of the
    others."""
    s = small_rans.solver
    w_list = padded(s, small_rans.start)
    w32, winf32, m32 = _as32(s, w_list)
    monkeypatch.setattr(s, "metrics_list", m32)
    if case == "float64":
        assert not _gate(s, w_list)
    elif case == "recording":
        w_rec = [w.clone().requires_grad_() for w in w32]
        assert not _gate(s, w_rec, winf32)
        with torch.no_grad():
            assert _gate(s, w_rec, winf32)
    elif case == "jvp":
        seen = []
        torch.func.jvp(lambda w: seen.append(_gate(s, [w], winf32)) or w,
                       (w32[0],), (torch.ones_like(w32[0]),))
        assert seen == [False]
    else:
        assert _gate(s, w32, winf32)


def test_iteration_captures_once_and_replays(monkeypatch):
    """A toy iteration that counts 5 K1 and 3 BC launches: 1 eager run, 1
    capture, replays after; the counters as if every run were eager; the
    forcing read once a ``force``; a replay's outputs overwritten by the
    next."""
    def body(w_list, f_list):
        cuda_rans.LAUNCHES += 5
        cuda_bc.LAUNCHES += 3
        return ([w * 2.0 + f for w, f in zip(w_list, f_list)],
                [w + 1.0 for w in w_list])

    stand_in(monkeypatch)
    it = rk_graph.IterationGraphs().iteration("k", body, lambda: True)
    before = counters()
    w = [torch.ones(3, dtype=torch.float64)]
    it.force([torch.zeros(3, dtype=torch.float64)])
    outs = []
    for i in range(4):
        if i == 2:
            it.force([torch.full((3,), 10.0, dtype=torch.float64)])
        w, r = it(w)
        outs.append((w[0].clone(), r[0]))
    assert [o[0].tolist()[0] for o in outs] == [2.0, 4.0, 18.0, 46.0]
    assert advanced(before) == dict(k1=20, k2=0, bc=12, irs=0, syncs=0,
                                    its=4, replays=3, captures=1)
    # the replays' residuals are one tensor, the last replay's
    assert outs[1][1] is outs[3][1] and outs[3][1].tolist()[0] == 19.0


def test_solve_rk_on_the_cpu(small_rans, monkeypatch):
    """No graph on the CPU; the stand-in graph's solve equal to it."""
    s = small_rans.solver
    before = counters()
    eager = rk_solve(s, padded(s, small_rans.start), 3)
    assert advanced(before) == dict(k1=0, k2=0, bc=0, irs=0, syncs=1,
                                    its=3, replays=0, captures=0)
    stand_in(monkeypatch)
    before = counters()
    graphed = rk_solve(s, padded(s, small_rans.start), 3)
    assert advanced(before)["replays"] == 2
    assert advanced(before)["captures"] == 1
    assert_same_solve(graphed, eager)


def test_solve_mg_on_the_cpu(monkeypatch):
    """'2w' over two cycles: no graph on the CPU; with the stand-in graph
    one capture a level, and the eager solve's state and history (the
    pre-smoothing's residual of level 0 outlives that level's
    post-smoothing replay)."""
    st = build("m6_rans_sa_mg", SMALL, "cpu", precision="float64",
               CFLCoarse=0.25, MGCycle="2w")
    s = st.solver
    before = counters()
    eager = mg_solve(s, padded(s, st.start), 2)
    # a cycle: level 0 pre and post, level 1 visited twice, 4 iterations
    assert advanced(before) == dict(k1=0, k2=0, bc=0, irs=0, syncs=1,
                                    its=2 * 10, replays=0, captures=0)
    stand_in(monkeypatch)
    before = counters()
    graphed = mg_solve(s, padded(s, st.start), 2)
    assert advanced(before)["captures"] == 2
    assert advanced(before)["replays"] == 20 - 2
    assert_same_solve(graphed, eager)


def test_the_benchmarks_readers(small_rans, monkeypatch):
    """``rk_replay_share`` and ``rk_capture_ms`` over a profiled solve with
    the stand-in graph (3 iterations: 1 eager, 2 replays, 1 capture
    span); None over spans without the counters, as a program without
    the graphs records them."""
    from torch.profiler import ProfilerActivity, profile

    from benchmark import harness

    share = harness.reader_module("rk_replay_share")
    capture = harness.reader_module("rk_capture_ms")
    ctx = SimpleNamespace(profile={})
    s = small_rans.solver
    stand_in(monkeypatch)
    with profile(activities=[ProfilerActivity.CPU]):
        with trace.span("api.solve"):
            rk_solve(s, padded(s, small_rans.start), 3)
    (cap,) = [x for x in trace.spans() if x.name == "smoother.graph_capture"]
    assert share.read(ctx, None, []) == 2 / 3
    assert capture.read(ctx, None, []) == 1e3 * cap.seconds > 0
    old = [x._replace(enter={"host_syncs": 0}, exit={"host_syncs": 0})
           for x in trace.spans()]
    monkeypatch.setattr(trace, "spans", lambda: old)
    assert share.read(ctx, None, []) is None
    assert capture.read(ctx, None, []) is None


# -- the card -----------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: CUDA graphs and the kernels have "
                    "no CPU mode")
    return "cuda:0"


@pytest.fixture
def eager_only(monkeypatch):
    """Run ``fn`` with the gate closed, as every iteration ran before."""
    def run(fn):
        with monkeypatch.context() as m:
            m.setattr(rk_graph, "graphable", lambda *a, **kw: False)
            return fn()
    return run


def _counted(fn):
    before = counters()
    out = fn()
    torch.cuda.synchronize()
    return out, advanced(before)


def _two_blocks(st, device):
    from adflow_torch import ADFLOW
    from adflow_torch.core import mesh as pmesh
    from adflow_torch.dist.stacked import split_block
    from benchmark import wing

    mesh = split_block(wing.build_mesh(st.spec, pmesh), 0, 0, CARD[0] // 2)
    s = ADFLOW(options=program.options(config("m6_rans_sa")), mesh=mesh,
               device=device)
    s.setAeroProblem(st.ap)
    return s


@pytest.mark.cuda
@pytest.mark.parametrize("blocks", [1, 2])
def test_solve_rk_replays_bitwise_on_card(cuda_device, eager_only, blocks):
    st = build("m6_rans_sa", CARD, cuda_device)
    s = st.solver if blocks == 1 else _two_blocks(st, cuda_device)
    start = s.getStates()
    eager, n_eager = _counted(lambda: eager_only(
        lambda: rk_solve(s, padded(s, start), 10)))
    graphed, n_graphed = _counted(lambda: rk_solve(s, padded(s, start), 10))
    assert_same_solve(graphed, eager)
    assert n_graphed["captures"] == 1 and n_graphed["replays"] == 9
    assert n_eager["replays"] == 0
    for k in ("k1", "k2", "bc", "irs", "syncs", "its"):
        assert n_graphed[k] == n_eager[k], k
    assert n_graphed["k1"] == 5 * 10 * blocks


@pytest.mark.cuda
def test_rk_smooth_replays_bitwise_at_each_level(cuda_device, eager_only):
    st = build("m6_rans_sa_mg", CARD, cuda_device)
    s = st.solver
    levels = s._mg_levels(3)
    gen = torch.Generator(device=cuda_device).manual_seed(11)
    for lev, level in enumerate(levels):
        cfg = mg._level_cfg(s.cfg, lev)
        dims = level.topo.blocks[0].dims
        w0 = s.winf.expand(tuple(d + 4 for d in dims) + (s.ref.nw,))
        w0 = w0 * (1.0 + 1e-4 * torch.randn(w0.shape, generator=gen,
                                            device=cuda_device))
        f = [1e-6 * torch.randn(dims + (s.ref.nw,), generator=gen,
                                device=cuda_device)]

        def smooth():
            return mg.rk_smooth([w0], level, cfg, s.ref, s.winf, 0.3, f,
                                n_iter=4, irs_eps=0.5)

        (we, re), n_eager = _counted(lambda: eager_only(smooth))
        (wg, rg), n_graphed = _counted(smooth)
        assert torch.equal(wg[0], we[0]) and torch.equal(rg[0], re[0]), lev
        assert torch.isfinite(wg[0]).all()
        assert n_graphed["captures"] == 1 and n_graphed["replays"] == 3
        for k in ("k1", "bc", "irs", "syncs", "its"):
            assert n_graphed[k] == n_eager[k], (lev, k)
        assert n_graphed["k1"] == 20 and n_graphed["irs"] == 60


@pytest.mark.cuda
def test_solve_mg_counts_and_captures_on_card(cuda_device, eager_only):
    """Two solves through ``ADFLOW``, the second at another Mach and CFL:
    each captures one graph a level anew, counts the launches and syncs
    of the eager solve, and returns its state and history bitwise."""
    from adflow_torch import AeroProblem

    st = build("m6_rans_sa_mg", CARD, cuda_device, CFLCoarse=0.25, nCycles=5)
    s = st.solver
    aps = [st.ap, AeroProblem(**dict(config("m6_rans_sa_mg")["conditions"],
                                     name="m6b", mach=0.7))]
    for ap, cfl in zip(aps, (1.7, 1.2)):
        s.setOption("CFL", cfl)
        s.setAeroProblem(ap)
        start = s.getStates()

        def solve():
            s.setStates(start)
            s(ap)
            return list(s.w_list), s.solve_info

        eager, n_eager = _counted(lambda: eager_only(solve))
        graphed, n_graphed = _counted(solve)
        assert_same_solve(graphed, eager)
        assert n_graphed["captures"] == 3
        assert n_graphed["replays"] == n_graphed["its"] - 3
        for k in ("k1", "k2", "bc", "irs", "syncs", "its"):
            assert n_graphed[k] == n_eager[k], k
        assert n_graphed["k1"] == 5 * 116


@pytest.mark.cuda
def test_the_profiler_sees_the_replays_kernels(cuda_device, eager_only):
    from torch.profiler import ProfilerActivity, profile

    st = build("m6_rans_sa_mg", CARD, cuda_device, CFLCoarse=0.25, nCycles=5)
    s = st.solver

    def kernels(run):
        s.setStates(st.start)
        s(st.ap)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            run(lambda: s(st.ap))
            torch.cuda.synchronize()
        names = [e.name() for e in prof.profiler.kineto_results.events()
                 if e.device_type() == torch.autograd.DeviceType.CUDA]
        return {k: sum(k in n for n in names) for k in (
            "rans_residual_kernel", "bc_ghost_kernel", "irs_line_kernel")}

    eager = kernels(eager_only)
    graphed = kernels(lambda fn: fn())
    assert eager["rans_residual_kernel"] == 5 * 116
    assert graphed == eager


@pytest.mark.cuda
def test_no_synchronising_copy_in_an_iteration(cuda_device):
    st = build("m6_rans_sa_mg", CARD, cuda_device)
    s = st.solver
    s.setStates(st.start)
    w_list = list(s.w_list)
    levels = s._mg_levels(3)
    inv_ts = smoothers.turb_unscale(s.cfg, w_list[0].dtype, w_list[0].device)
    rsv = s.cfg.row_scale(w_list[0].dtype, w_list[0].device)

    def iterations():
        smoothers.rk_iteration(w_list, s.metrics_list, s.topo, s.cfg, s.ref,
                               s.winf, 1.7, s.extras_list, inv_ts=inv_ts)
        mg.rk_smooth(w_list, levels[0], s.cfg, s.ref, s.winf, 1.7,
                     irs_eps=0.5, row_scale=rsv)

    iterations()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        iterations()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
