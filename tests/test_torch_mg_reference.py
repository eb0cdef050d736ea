"""FAS multigrid of the port against the benchmark's plain reference
(``benchmark/reference/multigrid.py``, written from ADflow's
``executeMGCycle`` and sharing only the plain residual pieces), in float64
on the CPU, on the wing of the benchmark's generator at 16x8x8 with the
``m6_rans_sa_mg`` configuration's options; and the levels ``ADFLOW``
keeps.

- one ``fas_cycle`` from seeded random starts: '2w' on the RANS-SA wing,
  '3w' on the Euler wing (a '3w' cycle of the 16x8x8 RANS-SA wing turns
  to NaN on its 4x2x2 level, in the reference as in the port), the
  first-stage residual and the final state;
- ``solve_mg`` through ``ADFLOW`` (``solver(ap)``: 5 '2w' cycles of the
  RANS-SA wing), the reported history, the state and the functions;
- ``ADFLOW._mg_levels``: built once for two solves, dropped after
  ``setSurfaceCoordinates`` and ``setGrid``;
- the spans of the cycles (``mg.cycle``, ``mg.level.<n>``,
  ``mg.transfer``, ``smoother.irs``) and the K1 and smoothing launches
  each level's own part counts;
- the reference imports nothing of the program or of JAX.

CFLCoarse 0.25 here, as in ``tests/test_torch_multigrid.py``: the small
wing's coarse levels diverge at 1.0.
"""

import json
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from adflow_torch.solvers import multigrid as mg
from benchmark import judge, program
from benchmark.reference.multigrid import Multigrid

ROOT = Path(__file__).resolve().parents[1]
CONFIG = json.loads((ROOT / "benchmark/configs/m6_rans_sa_mg.json")
                    .read_text())
DIMS = (16, 8, 8)
# A cycle is 10-60 RK stages, each a residual, a smoothing and an update,
# and the restrictions and prolongations between them. The program and the
# reference compute them in float64 in different orders (the reference's
# smoothing is a dense inverse of the line's matrix, the program's two
# sweeps; their sums of fluxes and pooled groups differ in order), so
# their states part by round-off, about 1e-15 a stage, grown through the
# stages: 1e-10 holds them with room; a fault moves them by 1e-3 or more.
CYCLE_RTOL = 1e-10
# five cycles through ``ADFLOW``: the same round-off grown further
SOLVE_RTOL = 1e-9


def _case(kind, seed, amp=1e-3, **over):
    """(ctx, the program's build: solver, start) for the benchmark's wing
    at DIMS, float64, from the free stream plus ``amp`` of each channel's
    largest magnitude times seeded normal noise."""
    config = dict(CONFIG, precision="float64", CFLCoarse=0.25, **over)
    if kind == "euler":
        config.update(equationType="euler",
                      mesh=dict(config["mesh"], viscous=False),
                      conditions={k: v for k, v in
                                  config["conditions"].items()
                                  if k != "reynolds"})
    cell = SimpleNamespace(config=config, traffic={
        "start": {"perturbation": amp},
        "launches": {"counter": "cuda_rans"}})
    ctx = SimpleNamespace(cell=cell, seed=seed, device="cpu",
                          mesh_dims=DIMS)
    return ctx, program.build(ctx)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


@pytest.mark.parametrize("kind,spec", [("rans", "2w"), ("euler", "3w")])
@pytest.mark.parametrize("seed", [3, 2147483659])
def test_fas_cycle_matches_the_reference(kind, spec, seed):
    ctx, st = _case(kind, seed, MGCycle=spec)
    s = st.solver
    s.setStates(st.start)
    opt = s.options
    n, ctype = mg.parse_mg_cycle(spec)
    w, r = mg.fas_cycle(
        s.w_list, s._mg_levels(n), s.cfg, s.ref, s.winf, float(opt["CFL"]),
        cycle=ctype, irs_eps=float(opt["smoothParameter"]) - 1.0,
        cfl_coarse=float(opt["CFLCoarse"]),
        vis2_coarse=float(opt["vis2Coarse"]))
    ref = judge.reference(ctx, st.spec)
    m = Multigrid(ref, program.options(ctx.cell.config))
    w_ref, r_ref = m.fas(ref.padded(ref.as_vec(st.start64)))
    for a, b in zip(r, r_ref):
        assert _rel(a, b) < CYCLE_RTOL
    got, want = judge.interior(w), judge.interior(w_ref)
    assert bool(torch.isfinite(got).all())
    nw = ref.nw
    for c in range(nw):
        assert _rel(got.reshape(-1, nw)[:, c],
                    want.reshape(-1, nw)[:, c]) < CYCLE_RTOL, c
    # the cycle moved the state
    assert _rel(got, st.start64) > 1e-4


def test_solve_mg_through_adflow_matches_the_reference():
    """5 '2w' cycles (one chunk) through ``solver(ap)`` from the
    benchmark's 1e-5 start: the reported norms at every cycle, the final
    state and cl, cd against the reference's cycles."""
    ctx, st = _case("rans", 2147483659, amp=1e-5, MGCycle="2w", nCycles=5)
    s = st.solver
    s.setStates(st.start)
    s(st.ap)
    info = s.solve_info
    assert info.iterations == 5 and not info.failed
    ref = judge.reference(ctx, st.spec)
    states, hist = Multigrid(ref, program.options(ctx.cell.config)).cycles(
        st.start64, 5)
    for c in range(2):
        assert _rel(info.history[:, c], hist[:, c]) < SOLVE_RTOL, c
    got = s.getStates()
    assert _rel(got, states[-1]) < SOLVE_RTOL
    f = s.evalFunctions(st.ap, {})
    want = ref.functions(states[-1])
    for k in ("cl", "cd"):
        assert abs(f[f"m6_{k}"] - want[k]) <= SOLVE_RTOL * abs(want[k]), k


def test_levels_are_built_once_and_dropped_with_the_coordinates(
        monkeypatch):
    _, st = _case("rans", 5, amp=1e-5, MGCycle="2w", nCycles=5)
    s = st.solver
    calls = []
    build = mg.build_mg_levels

    def counted(*args, **kw):
        calls.append(args[3])
        return build(*args, **kw)

    monkeypatch.setattr(mg, "build_mg_levels", counted)
    for _ in range(2):
        s.setStates(st.start)
        s(st.ap)
    assert calls == [2]
    levels = s._mg_levels(2)
    assert s._mg_levels(2) is levels and calls == [2]
    h = s.solve_info.history

    # the same surface staged again: a change of the coordinates all the
    # same, so the levels go
    s.setSurfaceCoordinates(s.getSurfaceCoordinates())
    assert s._mg_cache is None
    s.setStates(st.start)
    s(st.ap)
    assert calls == [2, 2]
    np.testing.assert_array_equal(s.solve_info.history, h)

    s.setGrid(s.getGrid())
    assert s._mg_cache is None
    assert s._mg_levels(2) is not levels and calls == [2, 2, 2]
    # another level count is another key
    s._mg_levels(3)
    assert calls == [2, 2, 2, 3]


def test_reference_imports_nothing_of_the_program():
    """The reference module loads no module of the program or of JAX (in a
    fresh interpreter)."""
    import subprocess
    import sys
    code = ("import sys; import benchmark.reference.multigrid; "
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('adflow_torch', 'adflow_tpu', 'jax', 'jaxlib')))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "[]"


def test_spans_and_counters_of_the_cycles(monkeypatch):
    """Under a profiler (the CPU's here), with K1 and the smoothing routed
    as on the card and counted (K1's plain version, the smoothing's CPU
    twin): one ``mg.cycle`` a cycle, one ``mg.level.0`` in it; every
    coarser level's span and every transfer under a level span; each
    level's own K1 launches (its spans less the level and transfer spans
    inside them) the evaluations on that level's dims, 3 smoothing
    launches in each ``smoother.irs``, 3 transfers a visit above the
    coarsest."""
    from torch.profiler import ProfilerActivity, profile
    from torch_irs_twin import twin_launch

    from adflow_torch.ops import cuda_irs, cuda_rans
    from adflow_torch.physics import residual
    from adflow_torch.solvers import smoothers
    from adflow_torch.utils import trace

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
    monkeypatch.setattr(smoothers, "_irs_kernel_applies", lambda r: True)
    monkeypatch.setattr(cuda_irs, "_launch", twin_launch)

    _, st = _case("rans", 9, amp=1e-5, MGCycle="2w", nCycles=5)
    s = st.solver
    s.setStates(st.start)
    with profile(activities=[ProfilerActivity.CPU]):
        s(st.ap)
    sp = trace.spans()
    by_id = {x.id: x for x in sp}
    assert len(dims) == 5 * 52
    assert dims.count((16, 8, 8)) == 5 * 11 and dims.count((8, 4, 4)) == \
        5 * 41

    def up(x, pred):
        p = by_id.get(x.parent)
        while p is not None and not pred(p.name):
            p = by_id.get(p.parent)
        return p

    def is_level(name):
        return name.startswith("mg.level.")

    cycles = [x for x in sp if x.name == "mg.cycle"]
    assert len(cycles) == 5
    tops = [x for x in sp if x.name == "mg.level.0"]
    assert len(tops) == 5 and all(
        by_id[x.parent].name == "mg.cycle" for x in tops)
    own = {x.id: x.count("k1_launches") for x in sp if is_level(x.name)}
    for x in sp:
        if is_level(x.name) and x.name != "mg.level.0" or \
                x.name == "mg.transfer":
            p = up(x, is_level)
            assert p is not None, x.name
            if is_level(x.name):
                assert int(p.name[9:]) == int(x.name[9:]) - 1
                own[p.id] -= x.count("k1_launches")
    per_level = {0: 0, 1: 0}
    for i, n in own.items():
        per_level[int(by_id[i].name[9:])] += n
    assert per_level == {0: 5 * 11, 1: 5 * 41}
    irs = [x for x in sp if x.name == "smoother.irs"]
    assert len(irs) == 5 * 50
    assert all(x.count("irs_launches") == 3 and up(x, is_level) is not None
               for x in irs)
    assert len([x for x in sp if x.name == "mg.transfer"]) == 5 * 3
    assert all(up(x, is_level) is not None
               for x in sp if x.name == "halo.fill"
               and up(x, lambda n: n == "mg.cycle") is not None)
