"""The in-loop per-layer readers (``benchmark/metrics``, through
``benchmark/spans.py``) on a synthetic list of the program's spans: each
reader's value, and None where there are no spans (the CPU, a run without
a profiled unit, or a program without the tracer)."""

from types import SimpleNamespace

import pytest

from adflow_torch.utils import trace
from benchmark import harness

MS = 1_000_000


def _tree():
    """Two ANK steps (3 and 2 GMRES iterations), one RK cycle with two
    halo fills, and one adjoint solve with 2 iterations, as (name, start
    ms, end ms, id, parent, host syncs); ids in the order spans open."""
    rows = [
        # ANK: step 1 builds its PC; GMRES: a restart's b - A x, three
        # iterations (PC apply, matvec), the update's PC apply
        ("api.solve", 0, 1000, 1, 0, 0),
        ("newton.step", 10, 500, 2, 1, 9),
        ("newton.pc_build", 10, 110, 3, 2, 0),
        ("krylov.gmres", 120, 420, 4, 2, 6),
        ("krylov.matvec", 121, 141, 5, 4, 0),
        ("krylov.iter", 142, 212, 6, 4, 1),
        ("krylov.precond", 143, 148, 7, 6, 0),
        ("krylov.matvec", 148, 208, 8, 6, 0),
        ("krylov.iter", 212, 282, 9, 4, 1),
        ("krylov.precond", 213, 219, 10, 9, 0),
        ("krylov.matvec", 219, 279, 11, 9, 0),
        ("krylov.iter", 282, 352, 12, 4, 1),
        ("krylov.precond", 283, 290, 13, 12, 0),
        ("krylov.matvec", 290, 350, 14, 12, 0),
        ("krylov.precond", 352, 360, 15, 4, 0),
        ("halo.fill", 150, 170, 16, 8, 0),
        ("newton.step", 500, 800, 17, 1, 7),
        ("newton.pc_build", 500, 700, 18, 17, 0),
        ("krylov.gmres", 700, 790, 19, 17, 5),
        ("krylov.matvec", 701, 711, 20, 19, 0),
        ("krylov.iter", 711, 741, 21, 19, 1),
        ("krylov.precond", 712, 716, 22, 21, 0),
        ("krylov.matvec", 716, 740, 23, 21, 0),
        ("krylov.iter", 741, 771, 24, 19, 1),
        ("krylov.precond", 742, 746, 25, 24, 0),
        ("krylov.matvec", 746, 770, 26, 24, 0),
        ("krylov.precond", 771, 781, 27, 19, 0),
        # RK: one cycle, two fills of two BC passes; a fill outside it
        ("api.solve", 1000, 1100, 28, 0, 0),
        ("smoother.cycle", 1000, 1080, 29, 28, 0),
        ("halo.fill", 1000, 1030, 30, 29, 0),
        ("halo.bc_pass", 1000, 1012, 31, 30, 0),
        ("halo.bc_pass", 1015, 1030, 32, 30, 0),
        ("halo.fill", 1040, 1060, 33, 29, 0),
        ("halo.bc_pass", 1040, 1050, 34, 33, 0),
        ("halo.bc_pass", 1050, 1058, 35, 33, 0),
        ("halo.fill", 1085, 1099, 36, 28, 0),
        # adjoint: its PC's build, GMRES with two iterations
        ("api.eval_functions_sens", 2000, 3000, 37, 0, 0),
        ("adjoint.solve", 2000, 2900, 38, 37, 0),
        ("adjoint.pc_build", 2010, 2510, 39, 38, 0),
        ("krylov.gmres", 2520, 2800, 40, 38, 4),
        ("krylov.matvec", 2521, 2571, 41, 40, 0),
        ("krylov.iter", 2571, 2671, 42, 40, 1),
        ("krylov.precond", 2572, 2592, 43, 42, 0),
        ("krylov.matvec", 2592, 2662, 44, 42, 0),
        ("krylov.iter", 2671, 2771, 45, 40, 1),
        ("krylov.precond", 2672, 2682, 46, 45, 0),
        ("krylov.matvec", 2682, 2752, 47, 45, 0),
        ("krylov.precond", 2771, 2781, 48, 40, 0),
    ]
    return [trace.Span(n, a * MS, b * MS, i, p, 1 if p == 0 else 0,
                       {"host_syncs": 0}, {"host_syncs": h})
            for n, a, b, i, p, h in rows]


EXPECTED = {
    "ank_matvec_span_ms": 24.0,        # median of 20, 60, 60, 60, 10, 24, 24
    "ank_pc_apply_span_ms": 6.0,       # median of 5, 6, 7, 8, 4, 4, 10
    "ank_pc_build_ms": 150.0,          # mean of 100, 200
    # (300 - 20 - 180 - 18 - 8) + (90 - 10 - 48 - 8 - 10) over 5 iterations
    "ank_gmres_self_ms": (74 + 14) / 5,
    "ank_syncs_per_step": 8.0,         # (9 + 7) / 2
    "rk_fill_span_ms": 25.0,           # median of 30, 20; not the fill at
    #                                    1085, outside the cycle
    "rk_bc_pass_ms": 11.0,             # median of 12, 15, 10, 8
    "adj_matvec_span_ms": 70.0,        # median of 50, 70, 70
    "adj_pc_apply_span_ms": 10.0,      # median of 20, 10, 10
    "adj_pc_build_ms": 500.0,
    "adj_gmres_self_ms": (280 - 50 - 140 - 40) / 2,
}


def _read(name, profiled=True):
    ctx = SimpleNamespace(profile={} if profiled else None, cuda=True)
    return harness.reader_module(name).read(ctx, None, [])


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_reader_on_synthetic_spans(monkeypatch, name):
    monkeypatch.setattr(trace, "spans", _tree)
    assert _read(name) == pytest.approx(EXPECTED[name], rel=1e-12)
    # no profiled unit: nothing read, though spans are there
    assert _read(name, profiled=False) is None


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_reader_without_spans(monkeypatch, name):
    monkeypatch.setattr(trace, "spans", lambda: [])
    assert _read(name) is None


def test_every_in_loop_reader_is_tested():
    bench = harness.load_benchmark()
    in_loop = {m["name"] for m in bench["per_layer"]
               if "spans.profiled" in
               (harness.BENCH / "metrics" / f"{m['name']}.py").read_text()}
    assert in_loop == set(EXPECTED)
