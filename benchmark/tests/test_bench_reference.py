"""The benchmark's plain reference held to the program on the CPU in
float64 at 16x8x8: the wing generator, the residual (Euler and RANS-SA),
the functions, the residual's jvp and vjp, an RK cycle, the ANK diagonal
and the adjoint's totals; and which modules the reference and the
harness load.

Run from the repository's root: ``python -m pytest benchmark/tests -q``.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark import harness, wing
from benchmark.reference import Reference
from benchmark.reference import mesh as rmesh

ROOT = Path(__file__).resolve().parents[2]
DIMS = (16, 8, 8)
EULER = dict(name="w", mach=0.84, alpha=3.06, evalFuncs=["cl", "cd"])
RANS = dict(EULER, reynolds=11.72e6)
OPTS = {"printIterations": False, "printTiming": False,
        "restartAdjoint": False}
TOL = 1e-12     # the same arithmetic in the same order: round-off only


def _pair(viscous, seed=5):
    """The program's solver and the reference on the same mesh and
    conditions, both float64 on the CPU, at a seeded perturbed state."""
    from adflow_torch import ADFLOW, AeroProblem
    from adflow_torch.core import mesh as pmesh

    spec = wing.wing_spec(*DIMS, viscous=viscous)
    cond = RANS if viscous else EULER
    opts = dict(OPTS, equationType="RANS" if viscous else "euler")
    solver = ADFLOW(options=opts, mesh=wing.build_mesh(spec, pmesh),
                    device="cpu")
    ap = AeroProblem(**cond)
    solver.setAeroProblem(ap)
    ref = Reference(wing.build_mesh(spec, rmesh), cond, opts)
    w = harness.seeded_start(solver.getStates().numpy(), solver.ref.nw,
                             seed, 1e-3)
    solver.setStates(w)
    return solver, ap, ref, torch.tensor(w)


def _rel(a, b):
    a, b = torch.as_tensor(a).double(), torch.as_tensor(b).double()
    return float((a - b).abs().max() / b.abs().max())


@pytest.fixture(scope="module", params=[False, True], ids=["euler", "rans"])
def pair(request):
    return _pair(request.param)


def test_generator_matches_the_programs():
    from adflow_torch.meshgen.analytic import wing_omesh
    for viscous in (False, True):
        got = wing.wing_spec(*DIMS, viscous=viscous)["blocks"][0]["x"]
        want = wing_omesh(*DIMS, viscous=viscous).blocks[0].x
        assert np.array_equal(got, want.astype(np.float32).astype(np.float64))


def test_residual_and_functions(pair):
    solver, ap, ref, w = pair
    r_prog = torch.cat([r.reshape(-1) for r in solver.getResidual(ap)])
    assert _rel(ref.residual(w), r_prog) < TOL
    f_prog = solver.evalFunctions(ap, {})
    f_ref = ref.functions(w)
    for k in ("cl", "cd"):
        assert abs(f_ref[k] - f_prog[f"w_{k}"]) < TOL * max(
            1.0, abs(f_prog[f"w_{k}"]))


def test_jvp_and_vjp(pair):
    solver, ap, ref, w = pair
    fns = solver._newton_fns()
    gen = torch.Generator().manual_seed(3)
    v = torch.randn(w.shape, generator=gen, dtype=torch.float64)
    _, jv_prog = torch.func.jvp(fns.res_flat, (w,), (v,))
    _, jv_ref = torch.func.jvp(ref.residual, (w,), (v,))
    assert _rel(jv_ref, jv_prog) < 1e-10
    _, vjp_prog = torch.func.vjp(fns.res_flat, w)
    _, vjp_ref = torch.func.vjp(ref.residual, w)
    assert _rel(vjp_ref(v)[0], vjp_prog(v)[0]) < 1e-10


def test_rk_cycles(pair):
    from adflow_torch.solvers.smoothers import residual_norms, rk_iteration
    solver, ap, ref, w = pair
    w_list, hist = solver.w_list, []
    for _ in range(3):
        w_list, r_list = rk_iteration(
            w_list, solver.metrics_list, solver.topo, solver.cfg,
            solver.ref, solver.winf, 1.7, solver.extras_list)
        hist.append([float(n) for n in residual_norms(r_list)])
    got, hist_ref = ref.rk_cycles(w, 3, 1.7)
    want = torch.cat([x[2:-2, 2:-2, 2:-2].reshape(-1) for x in w_list])
    assert _rel(got, want) < TOL
    assert np.allclose(hist_ref, np.array(hist), rtol=1e-11, atol=0.0)


def test_ank_diagonal_and_linear_residual(pair):
    solver, ap, ref, w = pair
    fns = solver._newton_fns()
    cfl = 50.0
    _, rs_list = fns.rad_sum_cells(w)
    nw = fns.packer.nw
    chan = (torch.ones(nw, dtype=torch.float64) if fns.row_scale_vec is None
            else fns.row_scale_vec)
    diag = fns.packer.pack([(rs / cfl)[..., None].expand(rs.shape + (nw,))
                            * chan for rs in rs_list])
    assert _rel(ref.ank_diagonal(w, cfl), diag) < TOL
    # the linear residual of a step direction, against the program's own
    # operator
    gen = torch.Generator().manual_seed(4)
    dx = 1e-4 * torch.randn(w.shape, generator=gen, dtype=torch.float64)
    r, jdx = torch.func.jvp(fns.res_flat, (w,), (dx,))
    want = float(torch.linalg.norm(diag * dx + jdx + r) / torch.linalg.norm(r))
    got = ref.ank_linear_residual(w, w + 0.5 * dx, 0.5, cfl)
    assert abs(got - want) < 1e-9 * want


def test_adjoint_totals():
    solver, ap, ref, w = _pair(False)
    solver.setOption("adjointMaxIter", 30)
    solver.setOption("adjointSubspaceSize", 30)
    sens = solver.evalFunctionsSens(ap, {}, ["cl"])["w_cl"]
    info = solver.adjoint_info
    rel, tot = ref.adjoint_check(w, info.x, "cl")
    assert abs(rel - info.res_norm / info.b_norm) < 1e-8
    for k in ("alpha", "mach"):
        assert abs(tot[k] - sens[k]) < 1e-9 * max(1.0, abs(sens[k]))
    assert _rel(sens["xv"], tot["xv"]) < 1e-9


CHECK_IMPORTS = r"""
import sys
sys.path[0] = {root!r}
import torch
from benchmark import reference, wing
from benchmark.reference import mesh
spec = wing.wing_spec(8, 4, 4)
ref = reference.Reference(wing.build_mesh(spec, mesh),
                          dict(name="w", mach=0.8, alpha=2.0),
                          {{"equationType": "euler"}})
ref.functions(ref.winf.expand(8 * 4 * 4, 5))
ref_only = sorted({{m.split(".")[0] for m in sys.modules}})
from benchmark import harness
cell = harness.find_cell(harness.load_benchmark(), "m6_euler.ank")
for kind in ("solve", "adjoint"):
    harness.driver_module(kind)
for kind in ("ank_steps", "rk_follow", "adjoint_totals"):
    harness.check_module(kind)
for m in cell.per_layer:
    harness.reader_module(m["name"])
import adflow_torch
print(" ".join(ref_only))
print(" ".join(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def test_what_the_reference_and_the_harness_load():
    out = subprocess.run(
        [sys.executable, "-c", CHECK_IMPORTS.format(root=str(ROOT))],
        capture_output=True, text=True, cwd=ROOT, timeout=300, check=True)
    ref_only, everything = (set(ln.split()) for ln in
                            out.stdout.strip().splitlines()[-2:])
    assert "adflow_torch" not in ref_only
    assert not ref_only & set(harness.FORBIDDEN)
    assert "adflow_torch" in everything
    assert not everything & set(harness.FORBIDDEN)
