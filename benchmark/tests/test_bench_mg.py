"""The multigrid cell ``m6_rans_sa_mg.fas`` on the CPU: its launch rule
(``drivers/mg.py``) against a counted '3w' cycle, its in-loop readers on a
profiled solve, a tiny run of the cell that is correct, each fault its
check ``mg_follow`` must catch, and the bfloat16 control.

The tiny runs compute in float64 on the benchmark's wing at 16x8x8 with
the cell's options but '2w' and CFLCoarse 0.25: the 16x8x8 wing's 4x2x2
level turns a '3w' cycle to NaN at any CFL (in the reference as in the
program), and its 8x4x4 level diverges at CFLCoarse 1.0. Five cycles, one
chunk of the program's history. The cell's own three-level '3w' cycle runs
at 32x16x16 (CFLCoarse 0.25, which stays finite there; 1.0 does not), five
cycles, as it is and with the two faults of its coarse levels."""

import copy
import functools
import sys
import time
from types import SimpleNamespace

import pytest
import torch

from adflow_torch.utils import trace
from benchmark import harness, mg_spans, program

CELL = "m6_rans_sa_mg.fas"
TINY = (16, 8, 8)
BENCH = harness.load_benchmark()
MG = harness.driver_module("mg")


def tiny_cell():
    cell = harness.find_cell(BENCH, CELL)
    cell.config = copy.deepcopy(cell.config)
    cell.traffic = copy.deepcopy(cell.traffic)
    cell.config.update(precision="float64", nCycles=5, MGCycle="2w",
                       CFLCoarse=0.25)
    cell.traffic["warmup_units"] = 0
    return cell


def tiny_run(seed=2147483659, controls=(), cell=None, mesh_dims=TINY):
    return harness.run_cell(cell or tiny_cell(), seed, 0.0, False,
                            time.perf_counter(), device="cpu",
                            mesh_dims=mesh_dims, controls=controls)


def _k1_counted(monkeypatch):
    """K1's route on the CPU: ``_kernel_applies`` as for a float32 CUDA
    state, the wrapper counting a launch and computing the plain
    version."""
    from adflow_torch.ops import cuda_rans
    from adflow_torch.physics import residual

    applies = residual._kernel_applies
    card = SimpleNamespace(dtype=torch.float32, is_cuda=True)
    monkeypatch.setattr(residual, "_kernel_applies",
                        lambda w, *a: applies(card, *a))
    dims = []

    def fused(*args, coarse=False):
        cuda_rans.LAUNCHES += 1
        dims.append(tuple(n - 4 for n in args[0].shape[:3]))
        return cuda_rans.rans_residual_reference(*args, coarse=coarse)

    monkeypatch.setattr(cuda_rans, "fused_rans_residual", fused)
    return dims


def _irs_counted(monkeypatch):
    """The smoothing kernel's route on the CPU, its launch the plain sweeps
    along the one axis, counted."""
    from adflow_torch.ops import cuda_irs
    from adflow_torch.solvers import smoothers
    from adflow_torch.solvers.dadi import tridiag_solve_factored

    def launch(src, dst, fac, axis):
        n = src.shape[axis]
        lines = tuple(d for i, d in enumerate(src.shape[:3]) if i != axis)
        f = [a.reshape((n, 1, 1)).expand((n,) + lines) for a in fac]
        dst.copy_(torch.movedim(tridiag_solve_factored(
            f, torch.movedim(src, axis, 0)), 0, axis))
        cuda_irs.LAUNCHES += 1

    monkeypatch.setattr(smoothers, "_irs_kernel_applies", lambda r: True)
    monkeypatch.setattr(cuda_irs, "_launch", launch)


def test_launch_rule_counts_a_3w_cycle(monkeypatch):
    """One '3w' cycle of the cell's options at 16x8x8 launches K1 as the
    rule says, level by level: 11 on 16x8x8, 23 on 8x4x4, 82 on 4x2x2,
    116 in all (the counts of the full wing's 256x64x64, 128x32x32 and
    64x16x16 levels)."""
    from adflow_torch.solvers import multigrid as mg

    dims = _k1_counted(monkeypatch)
    cell = harness.find_cell(BENCH, CELL)
    cfg = dict(cell.config, precision="float64")
    ctx = SimpleNamespace(cell=SimpleNamespace(config=cfg,
                                               traffic=cell.traffic),
                          seed=5, device="cpu", mesh_dims=TINY)
    st = program.build(ctx)
    s = st.solver
    s.setStates(st.start)
    mg.fas_cycle(s.w_list, s._mg_levels(3), s.cfg, s.ref, s.winf, 1.7,
                 cycle="w", irs_eps=0.5, cfl_coarse=1.0)
    want = MG.evaluations_by_level(cfg, MG.n_coarsest())
    assert want == [11, 23, 82]
    assert [dims.count(d) for d in ((16, 8, 8), (8, 4, 4), (4, 2, 2))] \
        == want
    assert MG.launches_per_cycle(SimpleNamespace(cell=cell)) == 116


def test_launch_rule_of_other_cycles():
    opts = {"MGCycle": "2v", "nMGFine": 2, "nMGCoarse": 1}
    assert MG.evaluations_by_level(opts, 4) == [5 * 3 + 1, 1 + 20]
    opts = {"MGCycle": "3v", "nMGFine": 1, "nMGCoarse": 1}
    assert MG.evaluations_by_level(opts, 4) == [11, 12, 21]


def test_the_rule_reads_the_programs_coarsest_iterations():
    """The rule's coarsest iterations are the program's own, and without
    the forced and restricted residuals it counts the RK stages, each a
    smoothing: 10, 2 x 10 and 4 x 4 x 5 a '3w' cycle."""
    from adflow_torch.solvers import multigrid as mg

    cell = harness.find_cell(BENCH, CELL)
    assert MG.n_coarsest() == 4
    assert "coarsest_iterations" not in cell.traffic["launches"]
    assert MG.evaluations_by_level(cell.config, MG.n_coarsest(), True) \
        == [10, 20, 80]
    assert MG.n_coarsest() == mg.fas_cycle.__defaults__[
        mg.fas_cycle.__code__.co_varnames.index("n_coarsest")
        - mg.fas_cycle.__code__.co_argcount]


def test_readers_on_a_profiled_solve(monkeypatch):
    """A tiny solve under the CPU profiler with K1 and the smoothing counted
    as on the card: the levels' own K1 and smoothing launches, and each
    reader gives a number (the device's times stand in)."""
    from torch.profiler import ProfilerActivity, profile

    from adflow_torch.ops import cuda_irs, cuda_rans

    _k1_counted(monkeypatch)
    _irs_counted(monkeypatch)
    cell = tiny_cell()
    ctx = SimpleNamespace(cell=cell, seed=9, device="cpu", mesh_dims=TINY,
                          profile=None)
    st = program.build(ctx)
    s = st.solver
    s.setStates(st.start)
    k1, irs = cuda_rans.LAUNCHES, cuda_irs.LAUNCHES
    with profile(activities=[ProfilerActivity.CPU]):
        s(st.ap)
    k1, irs = cuda_rans.LAUNCHES - k1, cuda_irs.LAUNCHES - irs
    ctx.profile = {"by_name": {"rans_residual_kernel<true>": (0.01, 1),
                               "rans_residual_kernel<false>": (0.01, 1),
                               "irs_line_kernel<6>": (0.001, 1)},
                   "idle_pct": 50.0}
    cycles, levels, transfer = mg_spans.split(ctx)
    assert cycles == 5
    per_level = MG.evaluations_by_level(cell.config, MG.n_coarsest())
    assert [levels[n][1] for n in (0, 1)] == [5 * c for c in per_level]
    assert k1 == 5 * sum(per_level)
    # three axes a smoothing, one smoothing a stage: 10 stages on the fine
    # level a cycle, 2 visits x 4 iterations x 5 stages on the coarse one
    assert [levels[n][2] for n in (0, 1)] == [5 * 30, 5 * 120]
    assert irs == 5 * 150
    assert transfer > 0.0 and all(v[0] > 0.0 for v in levels.values())
    for m in cell.per_layer:
        v = harness.reader_module(m["name"]).read(ctx, None, [])
        assert v is not None and v > 0.0, m["name"]


def _halo_tree():
    """Two W-cycles, each a level span with two fills of two BC passes
    (one fill on level 1, under level 0's span); a fill outside the
    cycles. (name, start ms, end ms, id, parent)."""
    rows = [("api.solve", 0, 100, 1, 0),
            ("mg.cycle", 0, 40, 2, 1),
            ("mg.level.0", 0, 40, 3, 2),
            ("halo.fill", 0, 10, 4, 3),
            ("halo.bc_pass", 0, 3, 5, 4),
            ("halo.bc_pass", 6, 10, 6, 4),
            ("mg.level.1", 20, 30, 7, 3),
            ("halo.fill", 20, 26, 8, 7),
            ("halo.bc_pass", 20, 22, 9, 8),
            ("halo.bc_pass", 24, 26, 10, 8),
            ("mg.cycle", 40, 80, 11, 1),
            ("mg.level.0", 40, 80, 12, 11),
            ("halo.fill", 40, 48, 13, 12),
            ("halo.bc_pass", 40, 43, 14, 13),
            ("halo.bc_pass", 45, 48, 15, 13),
            ("halo.fill", 85, 99, 16, 1),
            ("halo.bc_pass", 85, 90, 17, 16)]
    ms = 1_000_000
    return [trace.Span(n, a * ms, b * ms, i, q, 1 if q == 0 else 0, {}, {})
            for n, a, b, i, q in rows]


@pytest.mark.parametrize("name, want", [("mg_fill_ms", (10 + 6 + 8) / 2),
                                        ("mg_bc_pass_ms",
                                         (3 + 4 + 2 + 2 + 3 + 3) / 2)])
def test_halo_readers_on_synthetic_spans(monkeypatch, name, want):
    """The halo spans under ``mg.cycle``, summed, a cycle; None without
    spans, without a profiled unit, or without ``mg.cycle`` (a program
    without the multigrid spans)."""
    reader = harness.reader_module(name)
    monkeypatch.setattr(trace, "spans", _halo_tree)
    assert reader.read(SimpleNamespace(profile={}), None, []) \
        == pytest.approx(want, rel=1e-12)
    assert reader.read(SimpleNamespace(profile=None), None, []) is None
    monkeypatch.setattr(trace, "spans", lambda: [
        s for s in _halo_tree() if s.name != "mg.cycle"])
    assert reader.read(SimpleNamespace(profile={}), None, []) is None
    monkeypatch.setattr(trace, "spans", lambda: [])
    assert reader.read(SimpleNamespace(profile={}), None, []) is None


def test_tiny_run_is_correct():
    result, compared = tiny_run()
    assert result["correct"] and result["failed"] == 0, compared
    assert set(result["metrics"]) == {"setup_s", "rk_cycle_ms"}
    assert [c[0] for c in compared] == list(
        harness.find_cell(BENCH, CELL).traffic["check"]["limits"])


def _unchanged_cycle(monkeypatch):
    from adflow_torch.solvers import multigrid as mg
    orig = mg.fas_cycle

    @functools.wraps(orig)
    def cycle(w_list, *args, **kw):
        return w_list, orig(w_list, *args, **kw)[1]
    monkeypatch.setattr(mg, "fas_cycle", cycle)


def _coarse_correction_dropped(monkeypatch):
    from adflow_torch.solvers import multigrid as mg
    monkeypatch.setattr(mg, "prolong_correction",
                        lambda c, f: torch.zeros(
                            tuple(n * a for n, a in zip(c.shape[:3], f))
                            + tuple(c.shape[3:]), dtype=c.dtype))


def _smoothing_skipped(monkeypatch):
    from adflow_torch.solvers import multigrid as mg
    monkeypatch.setattr(mg, "residual_averaging", lambda r, eps: r)


def _coarse_sa_rows_doubled(monkeypatch):
    from adflow_torch.solvers import multigrid as mg
    orig = mg._forced_residual

    def forced(w_list, level, cfg, ref, f_list):
        r = orig(w_list, level, cfg, ref, f_list)
        if not cfg.coarse_level:
            return r
        return [torch.cat([a[..., :5], 2.0 * a[..., 5:]], dim=-1) for a in r]
    monkeypatch.setattr(mg, "_forced_residual", forced)


def _altered_cl(monkeypatch):
    from adflow_torch.api.solver import ADFLOW
    orig = ADFLOW.evalFunctions

    def funcs(self, ap, out, *args, **kw):
        out = orig(self, ap, out, *args, **kw)
        out[f"{ap.name}_cl"] += 1e-2
        return out
    monkeypatch.setattr(ADFLOW, "evalFunctions", funcs)


FAULTS = [_unchanged_cycle, _coarse_correction_dropped, _smoothing_skipped,
          _coarse_sa_rows_doubled, _altered_cl]


@pytest.mark.parametrize("fault", FAULTS, ids=[f.__name__[1:] for f in FAULTS])
def test_a_fault_in_the_cycle_is_not_correct(monkeypatch, fault):
    fault(monkeypatch)
    result, compared = tiny_run(seed=31)
    assert not result["correct"], compared


WIDE = (32, 16, 16)


def three_level_cell():
    cell = tiny_cell()
    cell.config.update(MGCycle="3w")
    return cell


@pytest.mark.parametrize("fault", [None, _coarse_correction_dropped,
                                   _coarse_sa_rows_doubled],
                         ids=["as_is", "coarse_correction_dropped",
                              "coarse_sa_rows_doubled"])
def test_the_3w_cycle_at_32x16x16(monkeypatch, fault):
    """The cell's '3w' cycle over three levels: correct as it is, not
    correct with a fault of its coarse levels."""
    if fault is not None:
        fault(monkeypatch)
    result, compared = tiny_run(seed=2147483661, cell=three_level_cell(),
                                mesh_dims=WIDE)
    if fault is None:
        assert result["failed"] == 0
    assert result["correct"] == (fault is None), compared


def test_the_bfloat16_control_is_not_correct():
    cell = tiny_cell()
    result, _ = tiny_run(seed=7, controls=("bfloat16",))
    limits = cell.traffic["check"]["limits"]
    readings = result["controls"]["bfloat16"]
    assert any(readings[k] > limits[k] for k in limits), readings


def test_forbidden_modules_stay_out_of_the_check():
    """The check's reference loads nothing of JAX: after a tiny run the
    harness's forbidden list holds only what the test process itself had
    loaded before."""
    before = set(harness.forbidden_loaded())
    tiny_run(seed=3)
    assert set(harness.forbidden_loaded()) <= before
    assert "benchmark.reference.multigrid" in sys.modules
