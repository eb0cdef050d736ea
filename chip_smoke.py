#!/usr/bin/env python3
"""Smoke run of adflow_torch on one NVIDIA card (H100).

    python3 chip_smoke.py

Run from the root of the repository on a machine with a CUDA card and the
CUDA toolkit. It builds the two kernels with nvcc, one process each, started
together: the fused RANS-SA residual (K1, adflow_torch/csrc/rans_residual.cu,
one pass that marches along i) and the central + JST inviscid residual (K2,
adflow_torch/csrc/inviscid_residual.cu, one pass that marches along i as
well). Then, each phase timed:
  [1]-[8]  K1 against its plain version, two of its launches against each
           other (bitwise), and its gradient; the steady
           RANS-SA Runge-Kutta solve of the 1.05 M-cell wing O-mesh through
           ``ADFLOW`` (a path of its own, K1 launches counted); K1's tile
           plan, registers and shared bytes, its times and one RK cycle's
           breakdown;
  [9]-[11] K2 against its plain version, on an odd block with a segment
           that does not divide ni, and two of its launches against each
           other (bitwise); jvp and vjp through both kernels'
           autograd.Functions on the card; a small Euler ANK solve on the
           card against the CPU;
  [12]     the main path: the default ANK solve of the Euler wing at
           256x64x64 through ``ADFLOW``, K2 launches counted per step;
  [13]     2 ANK steps of the RANS-SA wing at 64x24x16 through K1;
  [14]     K2's tile plan, registers and shared bytes, its times, one ANK
           step broken down, two ANK steps under torch.profiler.
Any failed check raises, so the exit code is not 0. The last line is
``{"ok": true, "device": {...}}``; the line before it lists the kernels with
their launches, errors and times (``ms`` by CUDA events around calls of the
wrapper, ``profiled_ms`` the profiler's device time a launch on the path).
Without a card it exits with 1 and prints no result.
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np
import torch

from adflow_torch.utils.timing import card_line, time_ms

# the flagship: the M6-class wing O-mesh of bench.py:105-108 at M6 conditions
FULL_DIMS = (256, 64, 64)
M6 = dict(name="m6", mach=0.84, alpha=3.06, reynolds=11.72e6,
          evalFuncs=["cl", "cd"])
N_CYCLES = 50
RK_STAGES = 5
SMALL_RTOL = 2e-5   # kernel vs plain, f32, small blocks (tests' tolerance)
# full size, perturbed state: the same check, with room for the f32 sums
# over 1 M cells of very different sizes
FULL_RTOL = 1e-4
FLUX_RTOL = 1e-5    # post-solve state, relative to the flux scale
GRAD_RTOL = 1e-6
SOLVE_RTOL = 1e-3   # f32 on the card vs f64 on the CPU after 25 RK cycles
# the main path: the default ANK solve of the Euler wing at M6 conditions
EULER = dict(name="m6e", mach=0.84, alpha=3.06, evalFuncs=["cl", "cd"])
ANK_STEPS = 5
K2_SMALL_DIMS = ((16, 8, 8), (15, 7, 5))   # tests/test_pallas.py's wing, odd
K2_ODD = ((37, 19, 33), 5)    # a block of no tile size, segment not dividing ni
# f32 on the card vs f64 on the CPU after 3 ANK steps: each step's GMRES
# stops at 5% of its right-hand side, so the f32 rounding moves where
# the Krylov iterations stop
ANK_SOLVE_RTOL = 1e-2
# the RANS-SA ANK path at the size of __graft_entry__.py
RANS_ANK_DIMS = (64, 24, 16)
RANS_ANK_STEPS = 2

# peak rates for the bound: (device-memory bytes/s, f32 FLOP/s outside the
# tensor cores), NVIDIA data sheets; the SXM part is the default
PEAKS = (("H100 PCIe", 2.0e12, 51e12), ("H100 NVL", 3.9e12, 60e12),
         ("H100", 3.35e12, 67e12))


def peaks(name: str):
    for key, bw, flops in PEAKS:
        if key in name:
            return bw, flops
    return PEAKS[-1][1:]


def rel_errors(want, got):
    """Per-channel max |got - want| / max |want|, and the max abs error."""
    diff = (got.double() - want.double()).abs()
    scale = want.double().abs().amax(dim=(0, 1, 2)) + 1e-30
    rel = (diff.amax(dim=(0, 1, 2)) / scale).tolist()
    return rel, float(diff.max())


def compare_kernel(label, tensors, consts, rtol):
    from adflow_torch.ops import cuda_rans
    got = cuda_rans.fused_rans_residual(*tensors, *consts)
    want = cuda_rans.rans_residual_reference(*tensors, *consts)
    torch.cuda.synchronize()
    rel, abs_err = rel_errors(want, got)
    print(f"  K1 vs plain {label}: shape {tuple(got.shape)}, per-channel "
          f"rel err {[f'{e:.3e}' for e in rel]}, max abs err {abs_err:.3e} "
          f"(tolerance {rtol:g})")
    assert got.shape == want.shape
    assert bool(torch.isfinite(got).all()), "kernel output not finite"
    assert max(rel) < rtol, f"K1 disagrees with its plain version: {rel}"
    return max(rel), abs_err


def check_bitwise(tensors, consts):
    """Two K1 launches on the same inputs give the same bits: every face is
    computed once and each cell sums its faces in a fixed order."""
    from adflow_torch.ops import cuda_rans
    a = cuda_rans.fused_rans_residual(*tensors, *consts)
    b = cuda_rans.fused_rans_residual(*tensors, *consts)
    torch.cuda.synchronize()
    same = bool(torch.equal(a, b))
    print(f"  two K1 launches on {tuple(a.shape[:3])}: bitwise equal {same}")
    assert same, "K1 launches differ"


def check_gradient(tensors, consts):
    """One vjp through the kernel's autograd.Function against the plain
    version's vjp."""
    from adflow_torch.ops import cuda_rans
    rest = tensors[1:]
    w = tensors[0].clone().requires_grad_(True)
    out = cuda_rans.fused_rans_residual(w, *rest, *consts)
    gen = torch.Generator(device=w.device).manual_seed(1)
    cot = torch.randn(out.shape, generator=gen, device=w.device)
    (g_fused,) = torch.autograd.grad(out, w, cot)
    _, vjp = torch.func.vjp(
        lambda a: cuda_rans.rans_residual_reference(a, *rest, *consts),
        tensors[0])
    (g_plain,) = vjp(cot)
    rel = float((g_fused - g_plain).abs().max()
                / (g_plain.abs().max() + 1e-30))
    print(f"  vjp through the autograd.Function vs plain vjp: rel err "
          f"{rel:.3e} (tolerance {GRAD_RTOL:g})")
    assert bool(torch.isfinite(g_fused).all())
    assert rel < GRAD_RTOL


def solver_options(n_cycles):
    return {"equationType": "RANS", "useANKSolver": False,
            "useNKSolver": False, "nCycles": n_cycles,
            "printIterations": False, "printTiming": False}


def small_solve_parity():
    """The port's RK solve on a small wing on the card (f32, through K1)
    against the same solve on the CPU (f64, plain version)."""
    from adflow_torch.api.solver import ADFLOW
    from adflow_torch.core.refstate import AeroProblem
    from adflow_torch.meshgen.analytic import wing_omesh

    runs = {}
    for device in ("cuda:0", "cpu"):
        solver = ADFLOW(options=solver_options(25),
                        mesh=wing_omesh(ni=16, nj=8, nk=8, viscous=True),
                        device=device)
        ap = AeroProblem(**M6)
        solver(ap)
        runs[device] = (solver.solve_info.history,
                        solver.evalFunctions(ap, {}), solver.dtype)
    (hg, fg, dg), (hc, fc, dc) = runs["cuda:0"], runs["cpu"]
    h_rel = float(np.abs(hg[:, 0] - hc[:, 0]).max() / np.abs(hc[:, 0]).max())
    f_rel = max(abs(fg[k] - fc[k]) / abs(fc[k]) for k in fc)
    print(f"  wing 16x8x8, 25 RK cycles: card ({dg}) vs CPU ({dc}): "
          f"history rel err {h_rel:.3e}, cl/cd rel err {f_rel:.3e} "
          f"(tolerance {SOLVE_RTOL:g}); cl {fg['m6_cl']:.6f} vs "
          f"{fc['m6_cl']:.6f}, cd {fg['m6_cd']:.6f} vs {fc['m6_cd']:.6f}")
    assert dg == torch.float32 and dc == torch.float64
    assert np.all(np.isfinite(hg))
    assert h_rel < SOLVE_RTOL and f_rel < SOLVE_RTOL


def main_path():
    """The port's main path: ADFLOW on the full wing, 50 RK cycles, then
    evalFunctions. Returns the solver and the K1 launches it made."""
    from adflow_torch.api.solver import ADFLOW
    from adflow_torch.core.refstate import AeroProblem
    from adflow_torch.meshgen.analytic import wing_omesh
    from adflow_torch.ops import cuda_inviscid, cuda_rans

    mesh = wing_omesh(ni=FULL_DIMS[0], nj=FULL_DIMS[1], nk=FULL_DIMS[2],
                      viscous=True)
    cuda_inviscid.LAUNCHES = cuda_rans.LAUNCHES = 0
    t0 = time.perf_counter()
    solver = ADFLOW(options=solver_options(N_CYCLES), mesh=mesh)
    ap = AeroProblem(**M6)
    solver.setAeroProblem(ap)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    solver(ap)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    funcs = solver.evalFunctions(ap, {})
    launches, k2 = cuda_rans.LAUNCHES, cuda_inviscid.LAUNCHES

    hist = solver.solve_info.history
    print(f"  {mesh.n_cells} cells, dtype {solver.dtype}, device "
          f"{solver.device}; set-up {t1 - t0:.3f} s")
    for it in (0, 24, N_CYCLES - 1):
        print(f"  cycle {it + 1:3d}: resrho {hist[it, 0]:.6e} "
              f"resturb {hist[it, 1]:.6e}")
    print(f"  {N_CYCLES} cycles in {t2 - t1:.3f} s: "
          f"{(t2 - t1) / N_CYCLES * 1e3:.3f} ms per cycle")
    print(f"  cl {funcs['m6_cl']!r}, cd {funcs['m6_cd']!r}")
    print(f"  K1 launches {launches} (expected {RK_STAGES} per cycle per "
          f"block: {RK_STAGES * N_CYCLES})")
    assert solver.dtype == torch.float32
    assert hist.shape == (N_CYCLES, 2) and np.all(np.isfinite(hist))
    assert np.isfinite(funcs["m6_cl"]) and np.isfinite(funcs["m6_cd"])
    assert launches == RK_STAGES * N_CYCLES and k2 == 0, (launches, k2)
    return solver, launches


def main_path_operands(solver):
    """K1's operands and constants as the main path gives them, at the
    solver's current state."""
    w = solver._filled_w()[0]
    m = solver.metrics_list[0]
    tensors = [w, m.siE, m.sjE, m.skE, m.vol, m.xc_ext,
               solver.extras_list[0]["walldist"], *solver.topo.blocks[0].por]
    cfg, ref = solver.cfg, solver.ref
    consts = (cfg.vis2, cfg.vis4, cfg.diss_exponent, ref.mu_inf,
              ref.t_inf_dim, cfg.use_ft2, cfg.turb_scales[0])
    return tensors, consts


def flux_scale(w, p, s_faces, sa_row_scale=None):
    """Each channel's flux scale: the largest |F(w) . S| over the lower
    faces of the interior cells, on every axis. With ``sa_row_scale`` an SA
    channel follows: the advective flux (u . S) nuTilde, row-scaled."""
    from adflow_torch.physics.fluxes import _euler_flux
    wc, pc = w[2:-2, 2:-2, 2:-2], p[2:-2, 2:-2, 2:-2]
    scale = None
    for axis, sE in enumerate(s_faces):
        sl = [slice(1, -1)] * 3
        sl[axis] = slice(1, -2)     # the lower face of each interior cell
        f = _euler_flux(wc, pc, sE[tuple(sl)])
        s = f.abs().amax(dim=(0, 1, 2))
        if sa_row_scale is not None:
            f_sa = (f[..., 0] / wc[..., 0] * wc[..., 5]).abs() * sa_row_scale
            s = torch.cat([s, f_sa.amax()[None]])
        scale = s if scale is None else torch.maximum(scale, s)
    return scale


def compare_post_solve(tensors, consts):
    """K1 against its plain version at the main path's post-solve state.

    There the residual is a difference of face fluxes some 1e5 times larger
    than itself, so f32 rounding of those fluxes, summed in another order by
    each version, is a large share of the residual. The tolerance is
    therefore taken relative to the flux scale of each channel (the largest
    |F(w) . S| over the interior faces). The plain version in f64 on the same
    inputs shows that both f32 versions stand equally far from it."""
    from adflow_torch.ops import cuda_rans
    from adflow_torch.physics.thermo import pressure

    got = cuda_rans.fused_rans_residual(*tensors, *consts)
    want = cuda_rans.rans_residual_reference(*tensors, *consts)
    want64 = cuda_rans.rans_residual_reference(
        *(t.double() for t in tensors), *consts)
    torch.cuda.synchronize()
    w = tensors[0]
    scale = flux_scale(w, pressure(w), tensors[1:4], sa_row_scale=consts[6])
    diff = (got.double() - want.double()).abs().amax(dim=(0, 1, 2))
    flux_rel = (diff / scale.double()).tolist()
    rel, abs_err = rel_errors(want, got)
    rel_k64, _ = rel_errors(want64, got)
    rel_p64, _ = rel_errors(want64, want)
    print(f"  K1 vs plain, post-solve state: max abs err {abs_err:.3e}; "
          f"per-channel err relative to the flux scale "
          f"{[f'{e:.3e}' for e in flux_rel]} (tolerance {FLUX_RTOL:g}); "
          f"relative to the residual {[f'{e:.3e}' for e in rel]}")
    print(f"  against the plain version in f64: K1 "
          f"{[f'{e:.3e}' for e in rel_k64]}, plain f32 "
          f"{[f'{e:.3e}' for e in rel_p64]}")
    assert bool(torch.isfinite(got).all()), "kernel output not finite"
    return max(rel), abs_err, max(flux_rel)


def compare_k2(label, tensors, consts, rtol):
    from adflow_torch.ops import cuda_inviscid
    got = cuda_inviscid.fused_inviscid_residual(*tensors, *consts)
    want = cuda_inviscid.inviscid_residual_reference(*tensors, *consts)
    torch.cuda.synchronize()
    rel, abs_err = rel_errors(want, got)
    print(f"  K2 vs plain {label}: shape {tuple(got.shape)}, per-channel "
          f"rel err {[f'{e:.3e}' for e in rel]}, max abs err {abs_err:.3e} "
          f"(tolerance {rtol:g})")
    assert got.shape == want.shape
    assert bool(torch.isfinite(got).all()), "kernel output not finite"
    assert max(rel) < rtol, f"K2 disagrees with its plain version: {rel}"
    return max(rel), abs_err


def check_k2_plan_and_bitwise(dims, si):
    """K2 on ``dims`` with segment ``si`` against its plain version, then two
    K2 launches with the default plan bitwise equal: every face is computed
    once and each cell sums its faces in a fixed order."""
    from adflow_torch.ops import cuda_inviscid
    tensors, consts = cuda_inviscid.sample_operands(dims, "cuda:0")
    plan = cuda_inviscid.k2_tile_plan(*dims, si=si)
    got = cuda_inviscid._launch(tensors, *consts, plan=plan)
    want = cuda_inviscid.inviscid_residual_reference(*tensors, *consts)
    a = cuda_inviscid.fused_inviscid_residual(*tensors, *consts)
    b = cuda_inviscid.fused_inviscid_residual(*tensors, *consts)
    torch.cuda.synchronize()
    rel, abs_err = rel_errors(want, got)
    same = bool(torch.equal(a, b))
    print(f"  K2 vs plain {'x'.join(map(str, dims))}, segment {plan.si} "
          f"(grid {plan.grid}): per-channel rel err "
          f"{[f'{e:.3e}' for e in rel]}, max abs err {abs_err:.3e} "
          f"(tolerance {SMALL_RTOL:g}); two launches bitwise equal {same}")
    assert bool(torch.isfinite(got).all()), "kernel output not finite"
    assert max(rel) < SMALL_RTOL, f"K2 disagrees with its plain version: {rel}"
    assert same, "K2 launches differ"


def k2_operands(solver):
    """K2's operands and constants as the main path gives them, at the
    solver's current state."""
    from adflow_torch.physics.thermo import pressure
    w = solver._filled_w()[0]
    m = solver.metrics_list[0]
    cfg = solver.cfg
    return ([w, pressure(w), m.siE, m.sjE, m.skE, *solver.topo.blocks[0].por],
            (cfg.vis2, cfg.vis4, cfg.diss_exponent))


def compare_k2_post_solve(tensors, consts):
    """K2 against its plain version at the main path's final state, relative
    to each channel's flux scale (the largest |F(w) . S| over the interior
    faces), for the reason compare_post_solve gives."""
    from adflow_torch.ops import cuda_inviscid

    got = cuda_inviscid.fused_inviscid_residual(*tensors, *consts)
    want = cuda_inviscid.inviscid_residual_reference(*tensors, *consts)
    torch.cuda.synchronize()
    scale = flux_scale(tensors[0], tensors[1], tensors[2:5])
    diff = (got.double() - want.double()).abs().amax(dim=(0, 1, 2))
    flux_rel = (diff / scale.double()).tolist()
    rel, abs_err = rel_errors(want, got)
    print(f"  K2 vs plain, final state of the main path: max abs err "
          f"{abs_err:.3e}; per-channel err relative to the flux scale "
          f"{[f'{e:.3e}' for e in flux_rel]} (tolerance {FLUX_RTOL:g}); "
          f"relative to the residual {[f'{e:.3e}' for e in rel]}")
    assert bool(torch.isfinite(got).all()), "kernel output not finite"
    assert max(flux_rel) < FLUX_RTOL, flux_rel
    return abs_err, max(flux_rel)


def check_derivatives():
    """torch.func.jvp and one vjp through each kernel's autograd.Function
    (kernel forward, plain-version tangents) against the plain version's,
    on the card."""
    from adflow_torch.ops import cuda_inviscid, cuda_rans
    cases = (
        ("K1", cuda_rans.fused_rans_residual,
         cuda_rans.rans_residual_reference,
         cuda_rans.sample_operands((24, 12, 8), "cuda:0")),
        ("K2", cuda_inviscid.fused_inviscid_residual,
         cuda_inviscid.inviscid_residual_reference,
         cuda_inviscid.sample_operands((16, 8, 8), "cuda:0")))
    for name, fused, plain, (tensors, consts) in cases:
        w, rest = tensors[0], tensors[1:]
        gen = torch.Generator(device=w.device).manual_seed(2)
        tangent = torch.randn(w.shape, generator=gen, device=w.device) * w
        _, jv_k = torch.func.jvp(lambda a: fused(a, *rest, *consts), (w,),
                                 (tangent,))
        _, jv_p = torch.func.jvp(lambda a: plain(a, *rest, *consts), (w,),
                                 (tangent,))
        wg = w.clone().requires_grad_(True)
        out = fused(wg, *rest, *consts)
        cot = torch.randn(out.shape, generator=gen, device=w.device)
        (g_k,) = torch.autograd.grad(out, wg, cot)
        (g_p,) = torch.func.vjp(lambda a: plain(a, *rest, *consts), w)[1](
            cot)
        torch.cuda.synchronize()
        rj = float((jv_k - jv_p).abs().max() / (jv_p.abs().max() + 1e-30))
        rv = float((g_k - g_p).abs().max() / (g_p.abs().max() + 1e-30))
        print(f"  {name}: jvp rel err {rj:.3e}, vjp rel err {rv:.3e} "
              f"(tolerance {GRAD_RTOL:g})")
        assert bool(torch.isfinite(jv_k).all() and torch.isfinite(g_k).all())
        assert rj < GRAD_RTOL and rv < GRAD_RTOL


def euler_options(n_steps):
    return {"equationType": "euler", "nCycles": n_steps,
            "printIterations": False, "printTiming": False}


def print_steps(info, kernel):
    for i, r in enumerate(info.steps):
        print(f"  step {i + 1}: {r.kind} res {r.stats[1]:.6e}, CFL "
              f"{r.cfl:.4g}, Krylov iterations {int(r.stats[4])}, linres "
              f"{r.stats[5]:.3e}, {r.seconds * 1e3:.3f} ms, {kernel} "
              f"launches {r.res_evals}")


def small_ank_parity():
    """The port's default ANK solve of the 16x8x8 Euler wing on the card
    (f32, through K2) against the same solve on the CPU (f64, plain), 3 steps
    from the same seeded 0.1% perturbation of the free stream: at the exact
    free stream the residual sits on the kink of the JST sensor's |d2p|,
    where rounding picks the derivative (tests/torch_pairs.py)."""
    from adflow_torch.api.solver import ADFLOW
    from adflow_torch.core.refstate import AeroProblem
    from adflow_torch.meshgen.analytic import wing_omesh

    runs = {}
    w0 = None
    for device in ("cpu", "cuda:0"):
        solver = ADFLOW(options=euler_options(3),
                        mesh=wing_omesh(ni=16, nj=8, nk=8), device=device)
        ap = AeroProblem(**EULER)
        solver.setAeroProblem(ap)
        if w0 is None:
            w = solver.getStates().numpy().reshape(-1, 5)
            rng = np.random.default_rng(0)
            w0 = (w + 1e-3 * np.abs(w).max(axis=0)
                  * rng.standard_normal(w.shape)).reshape(-1)
        solver.setStates(w0)
        solver(ap)
        runs[device] = (solver.solve_info, solver.evalFunctions(ap, {}),
                        solver.dtype)
    (ic, fc, dc), (ig, fg, dg) = runs["cpu"], runs["cuda:0"]
    h_rel = float(np.abs(ig.history[:, 0] - ic.history[:, 0]).max()
                  / np.abs(ic.history[:, 0]).max())
    f_rel = max(abs(fg[k] - fc[k]) / abs(fc[k]) for k in fc)
    print(f"  wing 16x8x8, 3 ANK steps: card ({dg}) vs CPU ({dc}): history "
          f"rel err {h_rel:.3e}, cl/cd rel err {f_rel:.3e} (tolerance "
          f"{ANK_SOLVE_RTOL:g}); Krylov iterations card "
          f"{[int(r.stats[4]) for r in ig.steps]}, CPU "
          f"{[int(r.stats[4]) for r in ic.steps]}")
    assert dg == torch.float32 and dc == torch.float64
    assert np.all(np.isfinite(ig.history))
    assert h_rel < ANK_SOLVE_RTOL and f_rel < ANK_SOLVE_RTOL


def ank_main_path():
    """The port's main path: ADFLOW with default options on the full Euler
    wing, ANK_STEPS ANK steps, then evalFunctions. Returns the solver and
    the K2 launches it made."""
    from adflow_torch.api.solver import ADFLOW
    from adflow_torch.core.refstate import AeroProblem
    from adflow_torch.meshgen.analytic import wing_omesh
    from adflow_torch.ops import cuda_inviscid, cuda_rans

    mesh = wing_omesh(ni=FULL_DIMS[0], nj=FULL_DIMS[1], nk=FULL_DIMS[2])
    cuda_inviscid.LAUNCHES = cuda_rans.LAUNCHES = 0
    t0 = time.perf_counter()
    solver = ADFLOW(options=euler_options(ANK_STEPS), mesh=mesh)
    ap = AeroProblem(**EULER)
    solver.setAeroProblem(ap)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    solver(ap)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    funcs = solver.evalFunctions(ap, {})
    k2, k1 = cuda_inviscid.LAUNCHES, cuda_rans.LAUNCHES

    info = solver.solve_info
    print(f"  {mesh.n_cells} cells, dtype {solver.dtype}, device "
          f"{solver.device}; set-up {t1 - t0:.3f} s; free-stream residual "
          f"{info.total_r0:.6e}")
    print_steps(info, "K2")
    print(f"  {len(info.steps)} ANK steps in {t2 - t1:.3f} s: "
          f"{(t2 - t1) / len(info.steps) * 1e3:.3f} ms per step")
    print(f"  cl {funcs['m6e_cl']!r}, cd {funcs['m6e_cd']!r}")
    expected = 2 + sum(r.res_evals for r in info.steps)
    print(f"  K2 launches {k2} (expected {expected}: 2 for the Newton "
          f"driver's free-stream and starting norms + the steps'), K1 "
          f"launches {k1}")
    assert solver.dtype == torch.float32
    assert len(info.steps) == ANK_STEPS and not info.failed
    assert np.all(np.isfinite(info.history))
    assert np.isfinite(funcs["m6e_cl"]) and np.isfinite(funcs["m6e_cd"])
    assert info.history[-1, 0] < info.total_r0, "residual did not fall"
    assert k2 == expected and k1 == 0, (k2, k1)
    return solver, k2


def rans_ank_path():
    """The RANS-SA ANK path at a smaller depth: the default ANK solve of the
    viscous wing at RANS_ANK_DIMS, RANS_ANK_STEPS steps, through K1."""
    from adflow_torch.api.solver import ADFLOW
    from adflow_torch.core.refstate import AeroProblem
    from adflow_torch.meshgen.analytic import wing_omesh
    from adflow_torch.ops import cuda_inviscid, cuda_rans

    mesh = wing_omesh(ni=RANS_ANK_DIMS[0], nj=RANS_ANK_DIMS[1],
                      nk=RANS_ANK_DIMS[2], viscous=True)
    cuda_inviscid.LAUNCHES = cuda_rans.LAUNCHES = 0
    solver = ADFLOW(options=dict(solver_options(RANS_ANK_STEPS),
                                 useANKSolver=True), mesh=mesh)
    ap = AeroProblem(**M6)
    t0 = time.perf_counter()
    solver(ap)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    k1, k2 = cuda_rans.LAUNCHES, cuda_inviscid.LAUNCHES
    info = solver.solve_info
    print_steps(info, "K1")
    expected = 2 + sum(r.res_evals for r in info.steps)
    print(f"  {len(info.steps)} steps in {t1 - t0:.3f} s; K1 launches {k1} "
          f"(expected {expected}), K2 launches {k2}")
    assert len(info.steps) == RANS_ANK_STEPS
    assert np.all(np.isfinite(info.history))
    assert k1 == expected and k2 == 0, (k1, k2)
    return k1


def ank_breakdown(solver):
    """One ANK step of the main path's final state broken into its pieces
    (CUDA events), then two ANK steps under torch.profiler; returns K2's
    device ms a launch in them."""
    from adflow_torch.solvers import krylov, newton

    opts = solver.options
    fns = newton.build_newton_fns(
        solver.w_list, solver.metrics_list, solver.topo, solver.cfg,
        solver.ref, solver.winf, solver.extras_list)
    wvec = fns.packer.pack_w(solver.w_list)
    cfl = solver.solve_info.steps[-1].cfl
    axes, kappa = newton._pc_params(opts)
    pc = fns.build_pc(wvec, cfl, axes=axes, kappa=kappa)
    _, rs_list = fns.rad_sum_cells(wvec)
    diag = fns.packer.pack([(rs / cfl)[..., None].expand(rs.shape + (5,))
                            for rs in rs_list])
    r = fns.res_flat(wvec)
    v = r / torch.linalg.norm(r)

    def matvec(u):
        return diag * u + torch.func.jvp(fns.res_flat, (wvec,), (u,))[1]

    def precond(u):
        return newton.pc_apply_vec(pc, fns.packer, u)

    m = min(50, int(opts["ANKMaxIter"]))
    sols = []
    parts = (
        ("residual (K2)", lambda: fns.res_flat(wvec), 20),
        ("one jvp matvec", lambda: matvec(v), 20),
        ("PC build", lambda: fns.build_pc(wvec, cfl, axes=axes,
                                          kappa=kappa), 5),
        ("PC apply", lambda: precond(v), 20),
        ("GMRES solve", lambda: sols.append(krylov.gmres(
            matvec, -r, m=m, restarts=2,
            tol=float(opts["ANKLinearSolveTol"]), precond=precond)), 3),
    )
    for label, fn, reps in parts:
        print(f"  {label}: {time_ms(fn, reps=reps, warmup=1):.4f} ms "
              f"(median of {reps})")
    print(f"  GMRES: {sols[-1].iters} iterations, {sols[-1].matvecs} "
          f"matvecs, linres {sols[-1].res_norm / sols[-1].b_norm:.3e}")

    step = newton.make_ank_step(fns, opts)

    def two_steps():
        w = wvec
        for _ in range(2):
            w = step(w, cfl, pc).w

    return profile_device(two_steps, "2 ANK steps",
                          "inviscid_residual_kernel")


def profile_device(run, label, kernel):
    """``run()`` under torch.profiler: its wall time, the device's busy
    time, device ops and idle share, and the kernels that took most of the
    device time. Returns the device ms a launch of ``kernel`` (a name in
    the profile): the kernel's own time, with no host time in it, which CUDA
    events around a call hold where the host's call takes longer than the
    kernel."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    # host ops are left out; their kernels are listed themselves
    rows = sorted(((e.self_device_time_total, e.count, e.key)
                   for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA),
                  reverse=True)
    busy = sum(r[0] for r in rows)
    n_ops = sum(r[1] for r in rows)
    print(f"  profiler, {label}: wall {wall_us / 1e3:.3f} ms, device busy "
          f"{busy / 1e3:.3f} ms in {n_ops} device ops, idle share "
          f"{1.0 - busy / wall_us:.3f}")
    for dev, count, key in rows[:12]:
        print(f"    {dev / 1e3:9.3f} ms {count:7d}x  {key[:90]}")
    dev, count = next((d, c) for d, c, key in rows if kernel in key)
    print(f"  {kernel}: {count} launches, {dev / 1e3 / count:.4f} ms of "
          f"device time each")
    return dev / 1e3 / count


def kernel_times(label, fused, plain, tensors, consts, n_bytes, n_flop,
                 name):
    """Kernel and plain-version times (CUDA events, median of 20) and the
    bound: the larger of bytes over the memory rate and operations over
    the f32 rate."""
    ms = time_ms(lambda: fused(*tensors, *consts))
    plain_ms = time_ms(lambda: plain(*tensors, *consts))
    bw, f32_peak = peaks(name)
    t_bytes, t_flop = n_bytes / bw * 1e3, n_flop / f32_peak * 1e3
    bound_ms = max(t_bytes, t_flop)
    print(f"  {label} {ms:.4f} ms, plain {plain_ms:.4f} ms; bound "
          f"{bound_ms:.4f} ms ({n_bytes / 1e6:.1f} MB at {bw / 1e12:.2f} "
          f"TB/s -> {t_bytes:.4f} ms; {n_flop / 1e9:.3f} GFLOP at "
          f"{f32_peak / 1e12:.0f} TFLOP/s -> {t_flop:.4f} ms)")
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by="bytes" if t_bytes >= t_flop else "operations")


def cycle_breakdown(solver):
    """One RK cycle's pieces timed alone (CUDA events), then two cycles
    under torch.profiler: device time by kernel and the device's idle
    share; returns K1's device ms a launch in them."""
    from adflow_torch.physics.residual import block_residual, fill_halos
    from adflow_torch.physics.sa import sa_destruction_diag
    from adflow_torch.physics.thermo import pressure
    from adflow_torch.physics.timestep import local_timestep
    from adflow_torch.solvers.smoothers import rk_iteration

    s = solver
    cfl = float(s.options["CFL"])
    wf = fill_halos(s.w_list, s.metrics_list, s.topo, s.ref, s.winf)
    m, ex, por = s.metrics_list[0], s.extras_list[0], s.topo.blocks[0].por
    parts = {
        "fill_halos": lambda: fill_halos(s.w_list, s.metrics_list, s.topo,
                                         s.ref, s.winf),
        "block_residual (K1)": lambda: block_residual(wf[0], m, s.cfg, s.ref,
                                                      ex, por=por),
        "local_timestep": lambda: local_timestep(wf[0], pressure(wf[0]), m,
                                                 cfl, s.cfg, s.ref),
        "sa_destruction_diag": lambda: sa_destruction_diag(
            wf[0], m, ex["walldist"]),
        "rk_iteration (one cycle)": lambda: rk_iteration(
            s.w_list, s.metrics_list, s.topo, s.cfg, s.ref, s.winf, cfl,
            s.extras_list),
    }
    for label, fn in parts.items():
        print(f"  {label}: {time_ms(fn, reps=10, warmup=2):.4f} ms")

    def two_cycles():
        w = s.w_list
        for _ in range(2):
            w, _ = rk_iteration(w, s.metrics_list, s.topo, s.cfg, s.ref,
                                s.winf, cfl, s.extras_list)

    return profile_device(two_cycles, "2 cycles", "rans_residual_kernel")


class Phases:
    """Prints each phase's heading and, at the next one, its wall time."""

    def __init__(self):
        self.t0 = None

    def __call__(self, heading=None):
        if self.t0 is not None:
            print(f"  (phase wall time {time.perf_counter() - self.t0:.2f} s)")
        self.t0 = time.perf_counter() if heading else None
        if heading:
            print(heading)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 1
    from adflow_torch.ops import _nvcc, cuda_inviscid, cuda_rans

    card = card_line()
    name = torch.cuda.get_device_name(0)
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {name}")
    phase = Phases()

    phase("[1] build both kernels, one nvcc each, in parallel")
    for lib in _nvcc.build_all([cuda_rans.SRC, cuda_inviscid.SRC]):
        print(f"  built {lib.relative_to(_nvcc.BUILD_DIR.parents[1])}")

    phase("[2] K1 against its plain version on small blocks; two launches "
          "bitwise equal")
    for dims in ((24, 12, 8), (23, 11, 7)):
        tensors, consts = cuda_rans.sample_operands(dims, "cuda:0")
        compare_kernel("x".join(map(str, dims)), tensors, consts, SMALL_RTOL)
    check_bitwise(tensors, consts)

    phase("[3] gradient through the kernel's autograd.Function")
    check_gradient(*cuda_rans.sample_operands((24, 12, 8), "cuda:0"))

    phase("[4] small RK solve: card against CPU")
    small_solve_parity()

    phase("[5] RK path: ADFLOW RANS-SA RK solve of the "
          f"{'x'.join(map(str, FULL_DIMS))} wing")
    solver, k1_rk = main_path()

    phase("[6] K1 against its plain version at the full size")
    ni, nj, nk = FULL_DIMS
    compare_kernel("full size, perturbed state",
                   *cuda_rans.sample_operands(FULL_DIMS, "cuda:0"),
                   FULL_RTOL)
    tensors, consts = main_path_operands(solver)
    max_rel, max_abs, flux_rel = compare_post_solve(tensors, consts)

    phase("[7] K1's plan and build, its times (CUDA events, median of 20 "
          "after warm-up)")
    plan = cuda_rans.k1_tile_plan(
        ni, nj, nk, n_sm=torch.cuda.get_device_properties(0)
        .multi_processor_count)
    print(f"  tile plan at {ni}x{nj}x{nk}: {plan}")
    for line in _nvcc.ptxas_report(cuda_rans.SRC):
        print(f"  {line}")
    k1_times = kernel_times(
        "K1", cuda_rans.fused_rans_residual,
        cuda_rans.rans_residual_reference, tensors, consts,
        cuda_rans.min_bytes(ni, nj, nk), cuda_rans.flop_count(ni, nj, nk),
        name)

    phase("[8] where one RK cycle's time goes")
    k1_times["profiled_ms"] = cycle_breakdown(solver)
    del solver, tensors
    # the post-solve check of [6], held until the times are printed
    assert flux_rel < FLUX_RTOL, f"K1 disagrees with its plain version: " \
        f"{flux_rel:.3e} of the flux scale"

    phase("[9] K2 against its plain version, on an odd block with a ragged "
          "segment; two launches bitwise equal")
    for dims in K2_SMALL_DIMS:
        compare_k2("x".join(map(str, dims)),
                   *cuda_inviscid.sample_operands(dims, "cuda:0"), SMALL_RTOL)
    compare_k2("full size, perturbed state",
               *cuda_inviscid.sample_operands(FULL_DIMS, "cuda:0"), FULL_RTOL)
    check_k2_plan_and_bitwise(*K2_ODD)

    phase("[10] jvp and vjp through both kernels on the card")
    check_derivatives()

    phase("[11] small Euler ANK solve: card against CPU")
    small_ank_parity()

    phase("[12] main path: ADFLOW default ANK solve of the Euler "
          f"{'x'.join(map(str, FULL_DIMS))} wing")
    solver, k2_ank = ank_main_path()
    tensors, consts = k2_operands(solver)
    k2_abs, k2_flux_rel = compare_k2_post_solve(tensors, consts)

    phase("[13] RANS-SA ANK path: the "
          f"{'x'.join(map(str, RANS_ANK_DIMS))} wing through K1")
    k1_ank = rans_ank_path()

    phase("[14] K2's plan and build, its times (CUDA events, median of 20 "
          "after warm-up) and one ANK step's pieces")
    k2_plan = cuda_inviscid.k2_tile_plan(
        ni, nj, nk, n_sm=torch.cuda.get_device_properties(0)
        .multi_processor_count)
    print(f"  tile plan at {ni}x{nj}x{nk}: {k2_plan}")
    for line in _nvcc.ptxas_report(cuda_inviscid.SRC):
        print(f"  {line}")
    k2_times = kernel_times(
        "K2", cuda_inviscid.fused_inviscid_residual,
        cuda_inviscid.inviscid_residual_reference, tensors, consts,
        cuda_inviscid.min_bytes(ni, nj, nk),
        cuda_inviscid.flop_count(ni, nj, nk), name)
    k2_times["profiled_ms"] = ank_breakdown(solver)
    phase()

    print(card)
    print(json.dumps({"kernels": [
        {"name": "fused_rans_residual", "route": "cuda",
         "source": "adflow_torch/csrc/rans_residual.cu",
         "replaces": "adflow_tpu/ops/pallas_rans.py:58",
         "design": "one pass, i-march",
         "launches": k1_rk + k1_ank,
         "launches_by_path": {"rk_rans_wing_256x64x64": k1_rk,
                              "ank_rans_wing_64x24x16": k1_ank},
         "max_abs_err": max_abs, "max_rel_err": flux_rel,
         "max_rel_err_of_residual": max_rel, **k1_times,
         "library_ms": None},
        {"name": "fused_inviscid_residual", "route": "cuda",
         "source": "adflow_torch/csrc/inviscid_residual.cu",
         "replaces": "adflow_tpu/ops/pallas_residual.py:45",
         "design": "one pass, i-march",
         "launches": k2_ank,
         "launches_by_path": {"ank_euler_wing_256x64x64": k2_ank},
         "max_abs_err": k2_abs, "max_rel_err": k2_flux_rel, **k2_times,
         "library_ms": None},
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
