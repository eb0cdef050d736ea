#!/usr/bin/env python3
"""Smoke run of adflow_torch on one NVIDIA card (H100).

    python3 chip_smoke.py

Run from the root of the repository on a machine with a CUDA card and the
CUDA toolkit. It builds the fused RANS-SA residual kernel (K1,
adflow_torch/csrc/rans_residual.cu) with nvcc, holds it against its plain
PyTorch version, checks its gradient, runs the steady RANS-SA Runge-Kutta
solve of the 1.05 M-cell wing O-mesh through ``ADFLOW`` and times the
kernel. Any failed check raises, so the exit code is not 0. The last line is
``{"ok": true, "device": {...}}``; the line before it lists the kernels with
their launches, errors and times. Without a card it exits with 1 and prints
no result.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

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

# peak rates for the bound: (device-memory bytes/s, f32 FLOP/s outside the
# tensor cores), NVIDIA data sheets; the SXM part is the default
PEAKS = (("H100 PCIe", 2.0e12, 51e12), ("H100 NVL", 3.9e12, 60e12),
         ("H100", 3.35e12, 67e12))


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


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
    from adflow_torch.ops import cuda_rans

    mesh = wing_omesh(ni=FULL_DIMS[0], nj=FULL_DIMS[1], nk=FULL_DIMS[2],
                      viscous=True)
    cuda_rans.LAUNCHES = 0
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
    launches = cuda_rans.LAUNCHES

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
    assert launches == RK_STAGES * N_CYCLES, launches
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


def compare_post_solve(tensors, consts):
    """K1 against its plain version at the main path's post-solve state.

    There the residual is a difference of face fluxes some 1e5 times larger
    than itself, so f32 rounding of those fluxes, summed in another order by
    each version, is a large share of the residual. The tolerance is
    therefore taken relative to the flux scale of each channel (the largest
    |F(w) . S| over the interior faces). The plain version in f64 on the same
    inputs shows that both f32 versions stand equally far from it."""
    from adflow_torch.ops import cuda_rans
    from adflow_torch.physics.fluxes import _euler_flux
    from adflow_torch.physics.thermo import pressure

    got = cuda_rans.fused_rans_residual(*tensors, *consts)
    want = cuda_rans.rans_residual_reference(*tensors, *consts)
    want64 = cuda_rans.rans_residual_reference(
        *(t.double() for t in tensors), *consts)
    torch.cuda.synchronize()
    w, s_faces = tensors[0], [tensors[1], tensors[2], tensors[3]]
    p = pressure(w)
    wc, pc = w[2:-2, 2:-2, 2:-2], p[2:-2, 2:-2, 2:-2]
    scale = None
    for axis, sE in enumerate(s_faces):
        sl = [slice(1, -1)] * 3
        sl[axis] = slice(1, -2)     # the lower face of each interior cell
        f = _euler_flux(wc, pc, sE[tuple(sl)])
        # SA row: the advective flux (u . S) nuTilde, row-scaled
        f_sa = (f[..., 0] / wc[..., 0] * wc[..., 5]).abs() * consts[6]
        f = torch.cat([f.abs().amax(dim=(0, 1, 2)), f_sa.amax()[None]])
        scale = f if scale is None else torch.maximum(scale, f)
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


def cycle_breakdown(solver):
    """One RK cycle's pieces timed alone (CUDA events), then two cycles
    under torch.profiler: device time by kernel and the device's idle
    share."""
    from torch.profiler import ProfilerActivity, profile

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

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        w = s.w_list
        for _ in range(2):
            w, _ = rk_iteration(w, s.metrics_list, s.topo, s.cfg, s.ref,
                                s.winf, cfl, s.extras_list)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    rows = []
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue        # host ops; their kernels are listed themselves
        rows.append((e.self_device_time_total, e.count, e.key))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    n_kernels = sum(r[1] for r in rows)
    print(f"  profiler, 2 cycles: wall {wall_us / 1e3:.3f} ms, device busy "
          f"{busy / 1e3:.3f} ms in {n_kernels} device ops, idle share "
          f"{1.0 - busy / wall_us:.3f}")
    for dev, count, key in rows[:12]:
        print(f"    {dev / 1e3:9.3f} ms {count:6d}x  {key[:90]}")


def time_ms(fn, reps=20, warmup=3):
    """Median time of one call, by CUDA events around each call."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 1
    from adflow_torch.ops import cuda_rans

    card = card_line()
    name = torch.cuda.get_device_name(0)
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {name}")

    print("[1] build")
    t0 = time.perf_counter()
    lib = cuda_rans.build()
    print(f"  built {lib.relative_to(cuda_rans.BUILD_DIR.parents[1])} in "
          f"{time.perf_counter() - t0:.2f} s")

    print("[2] K1 against its plain version on small blocks")
    for dims in ((24, 12, 8), (23, 11, 7)):
        tensors, consts = cuda_rans.sample_operands(dims, "cuda:0")
        compare_kernel("x".join(map(str, dims)), tensors, consts, SMALL_RTOL)

    print("[3] gradient through the kernel's autograd.Function")
    check_gradient(*cuda_rans.sample_operands((24, 12, 8), "cuda:0"))

    print("[4] small RK solve: card against CPU")
    small_solve_parity()

    print("[5] main path: ADFLOW RANS-SA RK solve of the "
          f"{'x'.join(map(str, FULL_DIMS))} wing")
    solver, launches = main_path()

    print("[6] K1 against its plain version at the full size")
    ni, nj, nk = FULL_DIMS
    compare_kernel("full size, perturbed state",
                   *cuda_rans.sample_operands(FULL_DIMS, "cuda:0"),
                   FULL_RTOL)
    tensors, consts = main_path_operands(solver)
    max_rel, max_abs, flux_rel = compare_post_solve(tensors, consts)

    print("[7] times (CUDA events, median of 20 after warm-up)")
    ms = time_ms(lambda: cuda_rans.fused_rans_residual(*tensors, *consts))
    plain_ms = time_ms(
        lambda: cuda_rans.rans_residual_reference(*tensors, *consts))
    bw, f32_peak = peaks(name)
    n_bytes = cuda_rans.min_bytes(ni, nj, nk)
    n_flop = cuda_rans.flop_count(ni, nj, nk)
    t_bytes, t_flop = n_bytes / bw * 1e3, n_flop / f32_peak * 1e3
    bound_ms = max(t_bytes, t_flop)
    print(f"  K1 {ms:.4f} ms, plain {plain_ms:.4f} ms; bound {bound_ms:.4f} "
          f"ms ({n_bytes / 1e6:.1f} MB at {bw / 1e12:.2f} TB/s -> "
          f"{t_bytes:.4f} ms; {n_flop / 1e9:.3f} GFLOP at "
          f"{f32_peak / 1e12:.0f} TFLOP/s -> {t_flop:.4f} ms)")

    print("[8] where one RK cycle's time goes")
    cycle_breakdown(solver)

    # the post-solve check of [6], held until the times are printed
    assert flux_rel < FLUX_RTOL, f"K1 disagrees with its plain version: " \
        f"{flux_rel:.3e} of the flux scale"

    print(card)
    print(json.dumps({"kernels": [{
        "name": "fused_rans_residual",
        "route": "cuda",
        "source": "adflow_torch/csrc/rans_residual.cu",
        "replaces": "adflow_tpu/ops/pallas_rans.py:58",
        "launches": launches,
        "launches_per_cycle": launches // N_CYCLES,
        "max_abs_err": max_abs,
        "max_rel_err": flux_rel,
        "max_rel_err_of_residual": max_rel,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "bytes" if t_bytes >= t_flop else "operations",
        "library_ms": None,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
