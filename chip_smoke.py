#!/usr/bin/env python3
"""Smoke run of adflow_torch on one NVIDIA card (H100).

    python3 chip_smoke.py

Run from the root of the repository on a machine with a CUDA card and the
CUDA toolkit. It builds the four kernels with nvcc, one process each, started
together: the fused RANS-SA residual (K1, adflow_torch/csrc/rans_residual.cu,
one pass that marches along i, with a coarse-level instantiation), the
central + JST inviscid residual (K2, adflow_torch/csrc/inviscid_residual.cu,
one pass that marches along i as well), the physical-BC pass
(adflow_torch/csrc/bc_ghost.cu, one launch a subface, with its tangent) and
the implicit residual smoothing (adflow_torch/csrc/residual_averaging.cu,
one launch an axis, a thread a line). Then, each phase timed:
  [1]-[8]  K1 against its plain version, two of its launches against each
           other (bitwise), and its gradient; the steady
           RANS-SA Runge-Kutta solve of the 1.05 M-cell wing O-mesh through
           ``ADFLOW`` (a path of its own, K1 launches counted, each BC
           pass one BC kernel launch a subface); K1's tile plan,
           registers and shared bytes, its times and one RK cycle's
           breakdown;
  [9]-[11] K2 against its plain version, on an odd block with a segment
           that does not divide ni, and two of its launches against each
           other and against three launches on slabs of i-planes, as a
           block past its 32-bit offsets takes (bitwise); jvp and vjp
           through both kernels' autograd.Functions on the card; a small
           Euler ANK solve on the card against the CPU;
  [12]     the main path: the default ANK solve of the Euler wing at
           256x64x64 through ``ADFLOW``, K2 launches counted per step, each
           BC pass one BC kernel launch a subface and each jvp matvec's
           pass one more;
  [13]     2 ANK steps of the RANS-SA wing at 64x24x16 through K1;
  [14]     K2's tile plan, registers and shared bytes, its times, one ANK
           step broken down and under torch.profiler;
  [15]     small adjoints (``evalFunctionsSens``) on the card against the
           CPU: the 16x8x8 Euler wing through K2, with the dot-product
           identity; the 16x8x8 RANS-SA wing through K1, against the CPU
           with frozen turbulence and, unfrozen, against the same card run
           without the kernels (``useBlockettes: False``); exact launch
           counts;
  [16]     the main path's adjoint: ``evalFunctionsSens`` of cl on [12]'s
           solved 256x64x64 Euler wing, 40 GMRES iterations, K2 launches
           counted; the transposed PC's build and apply and one vjp
           matvec timed; the dot-product identity at full width; three
           adjoint GMRES iterations under torch.profiler;
  [17]     matrix dissipation on the main path's wing: 1 ANK step from the
           free stream with the characteristic line PC, exactly no kernel
           launch; the PC's build and apply, a jvp matvec, the upwind (Roe,
           van Albada) residual and its jvp timed; the peak device memory;
           one step under torch.profiler;
  [18]     small cases, card against CPU: the upwind residual for each
           Riemann solver and limiter and the matrix residual, a matrix ANK
           step, the plate's flow-through functions, each new BC's ghost
           fill on the channel; a precision='mixed' NK solve of the Euler
           wing, K2 in its f32 phase only;
  [19]     a turbulent flat plate (16x12, Re 1e4) converged on the card
           with precision='mixed' and NK: K1 in the f32 phase only, the
           f64 continuation after the handover; the f64 residual of its
           answer on the CPU below 1e-7 of the free-stream one, and the
           answer against a float64 solve on the CPU (a process of its
           own, run meanwhile);
  [20]     SST on the main path's mesh, viscous (RANS at the RK path's
           conditions): 1 ANK step from the free stream, K2 for every
           residual evaluation and no K1 launch; one SST residual, a jvp
           matvec, the 7-equation line PC timed; the peak device memory;
           one jvp matvec and one PC apply under torch.profiler;
  [21]     small cases, card against CPU with exact launch counts: SST, the
           SA variants (rotation, Edwards, QCR, second-order advection)
           through K2, SA with wall functions on the plate through K1,
           grid motion and the low-speed preconditioner with no kernel
           (their residuals and one ANK step each), actuator sources on
           the channel through K2, and ``evalFunctionsSens`` of cl in
           rotRate, rotCenter and machGrid on the Euler wing;
  [22]     the other solvers at full width: the full-multigrid start and
           5 '3w' FAS cycles of the RK path's 256x64x64 RANS-SA wing
           (K1 exactly on every level's evaluations, 116 a cycle by the
           benchmark's rule ``benchmark/drivers/mg.py``, counted level by
           level and instantiation, and the start's coarse solves, K2
           never; the smoothing kernel 3 launches a stage), one cycle
           profiled; then the DADI smoother on the same wing, one K1
           launch an iteration;
  [23]     the multigrid (AMG) preconditioner on the main path's Euler
           wing: 2 ANK steps (K2 exactly as in [12]), its build and apply
           timed, the peak device memory, and evalFunctionsSens(cl) with
           the transposed multigrid PC (20 GMRES iterations, 2 K2
           launches);
  [24]     2 BDF2 steps, 2 explicit RK4 steps and a 3-instance time
           spectral solve of the main path's Euler wing, K2 exactly on
           every residual evaluation, the stability derivatives;
  [25]     small cases, card against CPU with exact launch counts: a '2w'
           multigrid solve of the RANS-SA wing with its start (K1), DADI,
           an AMG ANK step and the AMG-transposed adjoint, BDF2, RK4 and
           time spectral on the Euler wing (K2);
  [26]     overset at full width: the viscous NACA 0012 O-mesh at
           256x64x64 (its JMAX face OVERSET) in the 130x67x72 Cartesian
           background ``cartesian_background`` makes, implicit hole cut,
           RANS-SA through ``ADFLOW``: the assembly timed, 1 ANK step (K1 on
           both blocks, exact launches) under torch.profiler,
           K1 against its plain version on the background block, the fill
           against an f64 fill on the CPU at every receiver; then
           ``setSurfaceCoordinates`` with a bump and ``updateGeometryInfo``
           (the warp against an f64 warp on the CPU, the quick wall distance
           against a full search), ``checkMeshQuality``, ``checkOverset``, 1
           ANK step and ``evalFunctionsSens(cl)`` (20 GMRES iterations, xv);
           the peak device memory;
  [27]     small overset cases, card against CPU with exact launch counts:
           box-in-box with its cut (K2: residual, 1 ANK step), the airfoil in
           its background (RANS, K1: residual, 1 ANK step), the two-patch
           zipper mesh's forces, a user surface on the channel, cperror2 and
           its adjoint, the overset airfoil's adjoint of cl, a warp with the
           quick wall-distance update;
  [28]     the design point's files on [12]/[16]'s solved wing, no new
           solve: the mesh through ``.npz`` and CGNS into ``gridFile``,
           ``writeSolution`` (one K2 launch for the residual menu), a
           restart bitwise equal to the written state, the nodal forces
           against ``evalFunctions``, the force, slice and lift files, a
           family function; each writer's and reader's seconds. Without
           h5py the CGNS files are in the ADF flavour;
  [29]     ``solveCL`` of [11]'s 16x8x8 wing on the card against a float64
           run on the CPU (a process of its own, started with [28]),
           ``solveErrorEstimate`` of cl at full width, a SIGUSR2 stop, the
           ``jaxProfileDir`` trace, the MPhys adapter's dot-product
           identity and the Tecplot volume and isosurface writers against
           the CPU's. [28] and [29] run right after [16], on its solver.
  [30]     several devices, under an NCCL process group of one rank on the
           card: ``checkPartitioning(4)`` and ``balance_blocks`` of the
           main path's wing (4 slots of 64x64x64), the stacked Euler
           residual at [16]'s state against the single block's (exactly 4
           K2 launches), the stacked exchange bitwise equal to the CPU's,
           1 stacked ANK step timed (K2 exactly 4 a residual evaluation),
           3 stacked RK steps of the viscous RANS-SA wing (K1 exactly 4 x 5
           a step); the small wing's stacked ANK step and the k-split
           residual, card against CPU. It runs right after [29].
  [31]     the BC pass kernel on the main path's wing at 256x64x64, for 5
           (Euler) and 6 (SA) channels: the pass and its jvp against the
           plain pass in float64 on the same float32 inputs, two passes
           bitwise equal; its registers, its times beside the byte bound
           (the clone of the padded state). It runs right after [3].
  [32]     the multigrid levels' kernels at the three levels of the
           256x64x64 wing (256x64x64, 128x32x32, 64x16x16), 6 channels:
           K1's coarse instantiation against the plain coarse residual in
           float64 on the same float32 inputs (each channel within 2e-5
           of its scale, or twice the plain float32 version's distance),
           two launches bitwise equal; the smoothing kernel along the
           three axes against the float64 plain sweeps (1e-6), 3 launches
           a call; each timed beside its byte bound and its plain
           version (``adflow_torch/ops/mg_timing.py``). It runs right
           after [31].
Any failed check raises, so the exit code is not 0. The last line is
``{"ok": true, "device": {...}}``; the line before it lists the kernels with
their launches, errors and times (``ms`` by CUDA events around calls of the
wrapper, ``profiled_ms`` the profiler's device time a launch on the path).
Without a card it exits with 1 and prints no result.
"""

from __future__ import annotations

import collections
import json
import multiprocessing
import sys
import time
from concurrent.futures import ProcessPoolExecutor

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

# [15], the small adjoints at the seeded perturbed free stream, the same
# GMRES budget on the card (f32) and the CPU (f64). The Euler adjoint
# converges to 1e-6 there (about 200 iterations); the RANS-SA one is held
# against the CPU with frozen turbulence for a fixed 100 iterations, where
# f32 and f64 still follow one Krylov path (unfrozen, far from
# convergence, a CPU run in f32 saw the two part ways). K1 against the
# plain route, both f32 on the card, runs unfrozen: psi is then not zero
# on the SA row, so its d/dmu_inf and d/dT through K1 reach the totals.
ADJ_DIMS = (16, 8, 8)
ADJ_EULER_OPTS = {"adjointMaxIter": 300}
ADJ_RANS_OPTS = {"frozenTurbulence": True, "adjointSubspaceSize": 100,
                 "adjointMaxIter": 100}
ADJ_ROUTE_OPTS = dict(ADJ_RANS_OPTS, frozenTurbulence=False)
ADJ_EULER_RTOL = 2e-3   # Euler totals and |xv|, f32 card vs f64 CPU
ADJ_RANS_RTOL = 1e-2    # RANS totals and |xv|, f32 card vs f64 CPU
# RANS totals through K1 against the plain route, both f32 on the card: the
# same linearization (K1's backward is the plain version), summed in
# another order
ROUTE_RTOL = 1e-4
# <J v, u> = <v, J^T u> in f32: both products carry the f32 rounding of
# face-flux differences that cancel (8.5e-8 on the small wing and 3.7e-8
# at full width on an H100); a wrong transpose is O(1)
DOT_RTOL_F32 = 1e-2
# [16], the main path's adjoint: depth cut to 40 GMRES iterations
FULL_ADJ_OPTS = {"adjointSubspaceSize": 40, "adjointMaxIter": 40,
                 "printIterations": True, "adjointMonitorStep": 10}

# [17], matrix dissipation on the main path's mesh, depth cut to 1 ANK
# step; and the upwind residual at its state
MATRIX = {"discretization": "central plus matrix dissipation"}
MATRIX_STEPS = 1
UPWIND = {"discretization": "upwind", "riemannSolver": "Roe",
          "limiter": "van Albada"}
# [18], the small cases: card (f32) against the CPU (f64) at the seeded
# perturbed free stream
UPWIND_VARIANTS = [("upwind", rs, lim) for rs in ("roe", "van leer")
                   for lim in ("van albada", "minmod", "no limiter",
                               "first order")] + [
    ("central plus matrix dissipation", "roe", "van albada")]
FLOW_FUNCS = ["mdot", "mavgptot", "mavgttot", "mavgps", "mavgmn",
              "aavgptot", "aavgps", "area"]
FLOW_RTOL = 1e-4    # the plate's flow-through functions, card vs CPU
BC_RTOL = 1e-6      # a ghost fill, card vs CPU, of the largest entry
CHANNEL_DIMS = (16, 8, 2)
MIXED = {"precision": "mixed", "useNKSolver": True}
# the small wing's mixed solve: to 1e-5 with NK below 1e-3, at most 10
# Krylov iterations an ANK step (host-bound steps on the card: 40 made it
# 225 s)
MIXED_WING_OPTS = dict(MIXED, nCycles=60, L2Convergence=1e-5,
                       NKSwitchTol=1e-3, ANKMaxIter=10)
# [19], a turbulent plate converged on the card with precision='mixed' and
# NK: the 16x12 flat plate of the CPU tests at Re 1e4 (the f32 phase
# through K1 to its handover at 1e-2, then the f64 continuation). Its
# answer is held to 1e-7 of the free-stream residual by its f64 residual
# on the CPU, and to a float64 solve of the same plate on the CPU, run in
# a process of its own meanwhile (cd, mid-plate cf, flow-through
# functions). The solve goes to 1e-8: the answer is packed back to f32,
# whose rounding alone leaves an f64 residual of 3e-8 to 5e-8 of the
# free-stream one (CPU runs). The 48x48 plate of tests/test_solve_rans.py
# does not converge in this script's time: its steps are host-bound,
# 10-30 s each on the card (PERF.md).
PLATE = dict(name="fp", mach=0.3, alpha=0.0, reynolds=1e4,
             reynoldsLength=1.0, T=300.0)
PLATE_DIMS = (16, 12)
PLATE_OPTS = {"equationType": "RANS", "useNKSolver": True,
              "L2Convergence": 1e-8, "nCycles": 60,
              "printIterations": False, "printTiming": False}
PLATE_CONV = 1e-7       # the answer's f64 residual, of the free-stream one
PLATE_REF_CONV = 1e-10  # the float64 reference, converged past the card's
PLATE_REF_THREADS = 2
PLATE_RTOL = 1e-5       # cd, cf and flow-through functions, against it

# [20], SST on the main path's mesh, viscous, at the RK path's
# conditions, depth cut to SST_STEPS ANK steps
SST_OPTS = {"useANKSolver": True, "turbulenceModel": "SST"}
SST_STEPS = 1
# [21], the slice's options on small cases, card (f32) against the CPU
# (f64): the grid motion and the plate of the CPU tests
GRID_MOTION = dict(rotRate=(0.0, 0.0, 30.0), rotCenter=(0.25, 0.1, 0.0),
                   machGrid=0.1)
PLATE_SMALL = dict(name="fp", mach=0.3, alpha=0.0, reynolds=1e6,
                   reynoldsLength=1.0, T=300.0)

# [22], the slice at full width: FAS multigrid on the RK path's wing, the
# full-multigrid start as the defaults run it, then MG_CYCLES W-cycles; the
# start's coarse RK solves capped at MG_COARSE_CYCLES iterations a level
# (whole chunks of 25). Then the DADI smoother on the same wing: nCycles
# DADI_CYCLES, which runs one chunk of 25 iterations
MG_OPTS = {"MGCycle": "3w", "MGStartLevel": -1}
MG_CYCLES = 5
MG_COARSE_CYCLES = 50
DADI_CYCLES = 5
# [23], the AMG preconditioner on the main path's Euler wing: AMG_STEPS ANK
# steps from the free stream, then the adjoint of cl with the transposed
# multigrid PC, cut to AMG_ADJ_ITERS GMRES iterations
AMG_OPTS = {"ANKGlobalPreconditioner": "multigrid"}
AMG_STEPS = 2
AMG_ADJ_ITERS = 20
# [24], unsteady and time spectral on the main path's Euler wing: 2
# physical steps of each scheme; 3 time-spectral instances pitched by 1
# degree, nCycles TS_CYCLES (one chunk of 25 cycles)
UNSTEADY_STEPS = 2
# explicit RK4's global step is bound by the smallest cells: about 1.5e-5
# at CFL 1 on the 256x64x64 wing (1.3e-3 on the 16x8x8 one), extrapolated
# from CPU runs at 64x16x16 to 128x32x32; 1e-4 diverged on the card
UNSTEADY_DT = {"BDF": 0.01, "explicit RK": 1e-5}
SMALL_UNSTEADY_DT = {"BDF": 0.01, "explicit RK": 1e-4}
TS_OPTS = {"equationMode": "time spectral", "timeIntervals": 3,
           "omegaFourier": 2.0 * 3.141592653589793, "useANKSolver": False,
           "useNKSolver": False, "CFL": 1.2}
TS_CYCLES = 10
# [25], the small cases' multigrid: the 16x8x8 wing's coarse levels need
# CFLCoarse 0.25 to stay finite (the CPU tests)
SMALL_MG_OPTS = {"MGCycle": "2w", "CFLCoarse": 0.25, "nCyclesCoarse": 25,
                 "useANKSolver": False}
SMALL_MG_CYCLES = 5
SMALL_HIST_RTOL = SOLVE_RTOL   # [4]'s small-RK tolerance

# [26], overset meshes and the geometry tail at full width: the viscous
# NACA 0012 O-mesh at the main path's cell count (its JMAX face OVERSET, the
# z faces symmetry planes, as the JAX package's overset tests extrude it) in
# the Cartesian background ``cartesian_background`` makes around it
# (130x67x72, 1,675,696 cells in all), implicit hole cut. The background's
# uniform core hugs the wall's bounding box (margin 0): with symmetry planes
# the JAX package's generator, which the port copies, leaves inverted cells
# between the core's start and the clip wherever the spacing is below the
# margin (ROADMAP.md section 3), and at the default margin 0.25 and the
# issue's scale 2.5 both packages refuse that mesh. RANS-SA at M 0.5, alpha 2, Re 1e6 on the chord, T 300 K, default
# options (ANK). Depth: OVS_STEPS[0] ANK step (under the profiler, device
# events only: the host events of its 237,000 device ops took 315 s to
# aggregate), the shape change (a smooth bump of OVS_BUMP chords on the upper
# surface, the IDW warp, the re-assembly and the quick wall-distance
# update), OVS_STEPS[1] more step and the adjoint of cl cut to OVS_ADJ_ITERS
# GMRES iterations
OVS_NEAR = dict(ni=256, nj=64, nk=64, radius=1.5, viscous=True)
OVS_BG = dict(scale=1.25, margin=0.0)
OVS_AP = dict(name="ovs", mach=0.5, alpha=2.0, reynolds=1e6,
              reynoldsLength=1.0, T=300.0, evalFuncs=["cl", "cd"])
OVS_STEPS = (1, 1)
OVS_BUMP = 0.005
OVS_ADJ_ITERS = 20
# the card's f32 warp against an f64 warp on the CPU of WARP_SAMPLE seeded
# nodes a block (the warp is pointwise, so a sample is exact): of the
# displacement scale, beyond half an f32 ulp of the coordinate, which the
# f32 node array itself rounds to
WARP_RTOL = 1e-5
WARP_SAMPLE = 20000
# wall distances in f32 against f64, absolute, in chords: about 16 f32
# ulps of the small background's largest coordinates (7 chords); relative
# to a first cell 1e-5 from the wall such rounding is 1e-2
WALLDIST_ATOL = 1e-5
# [27], the small overset cases of the CPU tests, card (f32) against the CPU
# (f64): the box-in-box Euler mesh with its explicit cut (12 and 14 cells a
# side), the 40x10 airfoil in its generated background (scale 4, far 6),
# the two-patch zipper mesh (24 and 15 cells along x, overlap 0.2), a
# user surface on the channel
OVS_SMALL_AIRFOIL = dict(ni=40, nj=10, nk=2, radius=1.2)
OVS_SMALL_BG = dict(scale=4.0, far=6.0)
OVS_SMALL_AP = dict(name="ov", mach=0.5, alpha=2.0, reynolds=1e6,
                    reynoldsLength=1.0, T=300.0, evalFuncs=["cl", "cd"])
# the overset airfoil's adjoint and cperror2's: a fixed 40 GMRES iterations
# in one cycle, the same on both devices (the overset airfoil's, whose
# fringe rows are zero rows, is unconverged after 300 on both, where f32
# and f64 part ways)
OVS_ADJ_OPTS = {"adjointSubspaceSize": 40, "adjointMaxIter": 40,
                "adjointL2Convergence": 1e-14}
SURF_FUNCS = ("mdot", "mavgptot", "mavgttot", "mavgps", "mavgmn", "area")
# [28], the design point's files on [12]/[16]'s solved 1.05 M-cell Euler
# wing, no new solve; the files go under build/ and are removed after
DESIGN_DIR = "build/design_point"
DESIGN_SLICES_Z = (0.5, 1.3, 2.2)   # off the k node planes (dz = 3/64)
DESIGN_LIFT_SEGMENTS = 16
FORCE_RTOL = 1e-5    # getForces' column sums against fx, fy, fz (f32)
# [29], solveCL on [11]'s 16x8x8 Euler wing (default ANK through K2), card
# (f32) against the CPU (f64, a process of its own) from the free stream at
# CL_ALPHA0; each inner solve stops at CL_OPTS' L2Convergence, which f32
# reaches on this wing in 7-10 steps (its ANK floors near 1.4e-4 of the
# free-stream residual on the card, PERF.md section 6); at 1.5e-3
# the f64 solves' cl is still 1.4e-4 from its converged value
CL_OPTS = {"nCycles": 12, "L2Convergence": 2.5e-4}
CL_STAR, CL_ALPHA0, CL_DELTA, CL_TOL, CL_MAX_ITER = 0.6, 2.0, 0.5, 1e-3, 8
CL_ALPHA_ATOL = 2e-3   # degrees, the final alpha, card against CPU
CL_ATOL = 1e-4         # each iterate's cl, card against CPU
CL_REF_THREADS = 2
MPHYS_DOT_RTOL = 1e-4  # the adapter's fwd/rev dot-product identity, f32
ISO_AMP = 5e-2         # the writers' state: a 5% seeded perturbation
ISO_SURFACES = {"mach": 0.9, "density": 1.02}

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


# [5]'s ms per RK cycle and residual drop per cycle, for [22]
RK_SUMMARY = {}


class ReplayCredit:
    """While active, credits the counts a Python-side wrapper made while an
    RK iteration was captured as a CUDA graph (``rk_graph.Iteration``)
    again at each replay of that graph, as the program does with the
    kernels' counters: a replay runs no Python. ``counts``: the wrapper's
    ``collections.Counter``."""

    def __init__(self, counts):
        self.counts, self.per_graph = counts, {}

    def __enter__(self):
        from adflow_torch.solvers import rk_graph
        from adflow_torch.utils import trace
        cls = self.cls = rk_graph.Iteration
        capture, call = self.orig = cls._capture, cls.__call__

        def captured(it, w_list):
            before = collections.Counter(self.counts)
            capture(it, w_list)
            self.per_graph[it] = self.counts - before
            self.counts.clear()
            self.counts.update(before)

        def called(it, w_list):
            n = trace.rk_graph_replays
            out = call(it, w_list)
            if trace.rk_graph_replays > n:
                self.counts.update(self.per_graph[it])
            return out

        cls._capture, cls.__call__ = captured, called
        return self

    def __exit__(self, *exc):
        self.cls._capture, self.cls.__call__ = self.orig


class BCPasses:
    """Counts the BC passes of the halo fills while active
    (``residual.apply_bcs`` swapped for a counting wrapper, restored on
    exit; a graph's replays credited by ``ReplayCredit``), and the BC
    kernel's launches meanwhile."""

    def __enter__(self):
        from adflow_torch.ops import cuda_bc
        from adflow_torch.physics import residual
        fn = self.orig = residual.apply_bcs
        self.counts, self.launches0 = collections.Counter(), cuda_bc.LAUNCHES

        def counted(*a, **k):
            self.counts["passes"] += 1
            return fn(*a, **k)

        residual.apply_bcs = counted
        self.credit = ReplayCredit(self.counts).__enter__()
        return self

    def __exit__(self, *exc):
        from adflow_torch.physics import residual
        self.credit.__exit__(*exc)
        residual.apply_bcs = self.orig

    @property
    def n(self):
        return self.counts["passes"]

    @property
    def launches(self):
        from adflow_torch.ops import cuda_bc
        return cuda_bc.LAUNCHES - self.launches0


def n_physical(solver):
    """The BC kernel's launches a pass of the solver's one block: one a
    physical subface."""
    from adflow_torch.physics.bc import physical_ops
    (blk,) = solver.topo.blocks
    return len(physical_ops(blk.bc_ops))


def main_path():
    """The port's main path: ADFLOW on the full wing, 50 RK cycles, then
    evalFunctions. Returns the solver, the K1 launches it made and the BC
    kernel's."""
    from adflow_torch.api.solver import ADFLOW
    from adflow_torch.core.refstate import AeroProblem
    from adflow_torch.meshgen.analytic import wing_omesh
    from adflow_torch.ops import cuda_bc, cuda_inviscid, cuda_rans

    mesh = wing_omesh(ni=FULL_DIMS[0], nj=FULL_DIMS[1], nk=FULL_DIMS[2],
                      viscous=True)
    cuda_inviscid.LAUNCHES = cuda_rans.LAUNCHES = cuda_bc.LAUNCHES = 0
    t0 = time.perf_counter()
    solver = ADFLOW(options=solver_options(N_CYCLES), mesh=mesh)
    ap = AeroProblem(**M6)
    solver.setAeroProblem(ap)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    with BCPasses() as passes:
        solver(ap)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        solve_passes = passes.n
        funcs = solver.evalFunctions(ap, {})
    launches, k2 = cuda_rans.LAUNCHES, cuda_inviscid.LAUNCHES
    bc_launches, per_pass = cuda_bc.LAUNCHES, n_physical(solver)

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
    print(f"  BC passes {passes.n} ({solve_passes} in the solve, expected 12 "
          f"a cycle: {12 * N_CYCLES}), BC kernel launches {bc_launches} "
          f"(expected {per_pass} a pass: {per_pass * passes.n})")
    assert solver.dtype == torch.float32
    assert hist.shape == (N_CYCLES, 2) and np.all(np.isfinite(hist))
    assert np.isfinite(funcs["m6_cl"]) and np.isfinite(funcs["m6_cd"])
    assert launches == RK_STAGES * N_CYCLES and k2 == 0, (launches, k2)
    assert solve_passes == 12 * N_CYCLES, solve_passes
    assert bc_launches == passes.launches == per_pass * passes.n, \
        (bc_launches, passes.n)
    RK_SUMMARY.update(ms=(t2 - t1) / N_CYCLES * 1e3,
                      drop=float((hist[-1, 0] / hist[0, 0])
                                 ** (1.0 / (N_CYCLES - 1))))
    return solver, launches, bc_launches


def main_path_operands(solver, block=0):
    """K1's operands and constants as the main path gives them to
    ``block``, at the solver's current state."""
    w = solver._filled_w()[block]
    m = solver.metrics_list[block]
    tensors = [w, m.siE, m.sjE, m.skE, m.vol, m.xc_ext,
               solver.extras_list[block]["walldist"],
               *solver.topo.blocks[block].por]
    cfg, ref = solver.cfg, solver.ref
    consts = (cfg.vis2, cfg.vis4, cfg.diss_exponent, ref.mu_inf,
              ref.t_inf_dim, cfg.use_ft2, cfg.turb_scales[0])
    return tensors, consts


def flux_scale(w, p, s_faces, turb_scales=()):
    """Each channel's flux scale: the largest |F(w) . S| over the lower
    faces of the interior cells, on every axis. Each of ``turb_scales``
    adds a turbulence channel: its advective flux (u . S) q, row-scaled."""
    from adflow_torch.physics.fluxes import _euler_flux
    wc, pc = w[2:-2, 2:-2, 2:-2], p[2:-2, 2:-2, 2:-2]
    scale = None
    for axis, sE in enumerate(s_faces):
        sl = [slice(1, -1)] * 3
        sl[axis] = slice(1, -2)     # the lower face of each interior cell
        f = _euler_flux(wc, pc, sE[tuple(sl)])
        s = [f.abs().amax(dim=(0, 1, 2))]
        for i, ts in enumerate(turb_scales):
            s.append(((f[..., 0] / wc[..., 0] * wc[..., 5 + i]).abs()
                      * ts).amax()[None])
        s = torch.cat(s)
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
    scale = flux_scale(w, pressure(w), tensors[1:4],
                       turb_scales=(consts[6],))
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

    # a block past the 32-bit offsets is one launch a slab of i-planes: the
    # limit lowered to make three slabs of this block
    limit = cuda_inviscid.W5_MAX_FLOATS
    cuda_inviscid.W5_MAX_FLOATS = 5 * (dims[1] + 4) * (dims[2] + 4) * (
        -(-dims[0] // 3) + 4)
    try:
        slabs = cuda_inviscid.k2_slabs(*dims)
        before = cuda_inviscid.LAUNCHES
        c = cuda_inviscid.fused_inviscid_residual(*tensors, *consts)
        torch.cuda.synchronize()
        n = cuda_inviscid.LAUNCHES - before
    finally:
        cuda_inviscid.W5_MAX_FLOATS = limit
    same = bool(torch.equal(a, c))
    print(f"  K2 in slabs {slabs}: {n} launches, bitwise equal to one "
          f"launch {same}")
    assert n == len(slabs) == 3 and same, "K2's slabs differ"


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


def print_steps(info, evals="K2 launches"):
    for i, r in enumerate(info.steps):
        print(f"  step {i + 1}: {r.kind} res {r.stats[1]:.6e}, CFL "
              f"{r.cfl:.4g}, Krylov iterations {int(r.stats[4])}, linres "
              f"{r.stats[5]:.3e}, {r.seconds * 1e3:.3f} ms, {evals} "
              f"{r.res_evals}")


def perturbed_state(solver, seed=0, amp=1e-3):
    """The solver's (free-stream) interior states plus ``amp`` times each
    channel's largest magnitude times seeded normal noise, as numpy."""
    w = solver.getStates().cpu().numpy().reshape(-1, solver.ref.nw)
    rng = np.random.default_rng(seed)
    return (w + amp * np.abs(w).max(axis=0)
            * rng.standard_normal(w.shape)).reshape(-1)


def small_ank_parity(n_steps=3, options=None, ap_changes=None):
    """The port's default ANK solve of the 16x8x8 Euler wing on the card
    (f32, through K2 with the default options) against the same solve on
    the CPU (f64, plain), ``n_steps`` steps from the same seeded 0.1%
    perturbation of the free stream: at the exact free stream the residual
    sits on the kink of the JST sensor's |d2p|, where rounding picks the
    derivative (tests/torch_pairs.py)."""
    from adflow_torch.api.solver import ADFLOW
    from adflow_torch.core.refstate import AeroProblem
    from adflow_torch.meshgen.analytic import wing_omesh

    runs = {}
    w0 = None
    for device in ("cpu", "cuda:0"):
        solver = ADFLOW(options=dict(euler_options(n_steps),
                                     **(options or {})),
                        mesh=wing_omesh(ni=16, nj=8, nk=8), device=device)
        ap = AeroProblem(**dict(EULER, **(ap_changes or {})))
        solver.setAeroProblem(ap)
        if w0 is None:
            w0 = perturbed_state(solver)
        solver.setStates(w0)
        solver(ap)
        runs[device] = (solver.solve_info, solver.evalFunctions(ap, {}),
                        solver.dtype)
    (ic, fc, dc), (ig, fg, dg) = runs["cpu"], runs["cuda:0"]
    h_rel = float(np.abs(ig.history[:, 0] - ic.history[:, 0]).max()
                  / np.abs(ic.history[:, 0]).max())
    f_rel = max(abs(fg[k] - fc[k]) / abs(fc[k]) for k in fc)
    print(f"  wing 16x8x8, {n_steps} ANK steps, {options or 'defaults'}"
          f"{', ' + str(ap_changes) if ap_changes else ''}: "
          f"card ({dg}) vs CPU ({dc}): history "
          f"rel err {h_rel:.3e}, cl/cd rel err {f_rel:.3e} (tolerance "
          f"{ANK_SOLVE_RTOL:g}); Krylov iterations card "
          f"{[int(r.stats[4]) for r in ig.steps]}, CPU "
          f"{[int(r.stats[4]) for r in ic.steps]}")
    assert dg == torch.float32 and dc == torch.float64
    assert np.all(np.isfinite(ig.history))
    assert h_rel < ANK_SOLVE_RTOL and f_rel < ANK_SOLVE_RTOL


def ank_main_path():
    """The port's main path: ADFLOW with default options on the full Euler
    wing, ANK_STEPS ANK steps, then evalFunctions. Returns the solver, the
    K2 launches it made and the BC kernel's."""
    from adflow_torch.api.solver import ADFLOW
    from adflow_torch.core.refstate import AeroProblem
    from adflow_torch.meshgen.analytic import wing_omesh
    from adflow_torch.ops import cuda_bc, cuda_inviscid, cuda_rans

    mesh = wing_omesh(ni=FULL_DIMS[0], nj=FULL_DIMS[1], nk=FULL_DIMS[2])
    cuda_inviscid.LAUNCHES = cuda_rans.LAUNCHES = cuda_bc.LAUNCHES = 0
    t0 = time.perf_counter()
    solver = ADFLOW(options=euler_options(ANK_STEPS), mesh=mesh)
    ap = AeroProblem(**EULER)
    solver.setAeroProblem(ap)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    with BCPasses() as passes:
        solver(ap)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        funcs = solver.evalFunctions(ap, {})
    k2, k1 = cuda_inviscid.LAUNCHES, cuda_rans.LAUNCHES
    bc_launches, per_pass = cuda_bc.LAUNCHES, n_physical(solver)

    info = solver.solve_info
    print(f"  {mesh.n_cells} cells, dtype {solver.dtype}, device "
          f"{solver.device}; set-up {t1 - t0:.3f} s; free-stream residual "
          f"{info.total_r0:.6e}")
    print_steps(info)
    print(f"  {len(info.steps)} ANK steps in {t2 - t1:.3f} s: "
          f"{(t2 - t1) / len(info.steps) * 1e3:.3f} ms per step")
    print(f"  cl {funcs['m6e_cl']!r}, cd {funcs['m6e_cd']!r}")
    expected = 2 + sum(r.res_evals for r in info.steps)
    print(f"  K2 launches {k2} (expected {expected}: 2 for the Newton "
          f"driver's free-stream and starting norms + the steps'), K1 "
          f"launches {k1}")
    matvecs = sum(r.krylov_matvecs for r in info.steps)
    bc_expected = per_pass * (passes.n + 2 * matvecs)
    print(f"  BC passes {passes.n}, {2 * matvecs} of them in the jvp "
          f"matvecs; BC kernel launches {bc_launches} (expected "
          f"{bc_expected}: {per_pass} a pass and {per_pass} more a "
          f"matvec's pass for the tangent)")
    assert solver.dtype == torch.float32
    assert len(info.steps) == ANK_STEPS and not info.failed
    assert np.all(np.isfinite(info.history))
    assert np.isfinite(funcs["m6e_cl"]) and np.isfinite(funcs["m6e_cd"])
    assert info.history[-1, 0] < info.total_r0, "residual did not fall"
    assert k2 == expected and k1 == 0, (k2, k1)
    assert bc_launches == passes.launches == bc_expected, \
        (bc_launches, passes.n, matvecs)
    return solver, k2, bc_launches


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
    print_steps(info, "K1 launches")
    expected = 2 + sum(r.res_evals for r in info.steps)
    print(f"  {len(info.steps)} steps in {t1 - t0:.3f} s; K1 launches {k1} "
          f"(expected {expected}), K2 launches {k2}")
    assert len(info.steps) == RANS_ANK_STEPS
    assert np.all(np.isfinite(info.history))
    assert k1 == expected and k2 == 0, (k1, k2)
    return k1


def ank_breakdown(solver):
    """One ANK step of the main path's final state broken into its pieces
    (CUDA events), then one ANK step under torch.profiler; returns K2's
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
    times = {}
    for label, fn, reps in parts:
        times[label] = time_ms(fn, reps=reps, warmup=1)
        print(f"  {label}: {times[label]:.4f} ms (median of {reps})")
    print(f"  GMRES: {sols[-1].iters} iterations, {sols[-1].matvecs} "
          f"matvecs, linres {sols[-1].res_norm / sols[-1].b_norm:.3e}")

    step = newton.make_ank_step(fns, opts)
    return (profile_device(lambda: step(wvec, cfl, pc), "1 ANK step",
                           "inviscid_residual_kernel"),
            (times["PC build"], times["PC apply"]))


def profile_device(run, label, kernel=None, host_ops=True):
    """``run()`` under torch.profiler: its wall time, the device's busy
    time, device ops and idle share, and the kernels that took most of the
    device time. Returns the device ms a launch of ``kernel`` (a name in
    the profile), if given: the kernel's own time, with no host time in it,
    which CUDA events around a call hold where the host's call takes longer
    than the kernel. ``host_ops=False`` traces the device only, for runs of
    hundreds of thousands of ops, whose host events take minutes to
    aggregate."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    activities = ([ProfilerActivity.CPU] if host_ops else []) + [
        ProfilerActivity.CUDA]
    with profile(activities=activities) as prof:
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
    if kernel is None:
        return None
    dev, count = next((d, c) for d, c, key in rows if kernel in key)
    print(f"  {kernel}: {count} launches, {dev / 1e3 / count:.4f} ms of "
          f"device time each")
    return dev / 1e3 / count


def small_adjoint(equation, device, funcs, w0=None, ap_changes=None,
                  **options):
    """``evalFunctionsSens`` of ``funcs`` on the 16x8x8 wing at the seeded
    perturbed free stream (``w0``, else made here), with the launches it
    made on the card: (totals, solver, K1 launches, K2 launches, w0)."""
    from adflow_torch.api.solver import ADFLOW
    from adflow_torch.core.refstate import AeroProblem
    from adflow_torch.meshgen.analytic import wing_omesh
    from adflow_torch.ops import cuda_inviscid, cuda_rans

    rans = equation == "RANS"
    opts = dict(solver_options(1) if rans else euler_options(1), **options)
    solver = ADFLOW(options=opts, mesh=wing_omesh(
        ni=ADJ_DIMS[0], nj=ADJ_DIMS[1], nk=ADJ_DIMS[2], viscous=rans),
        device=device)
    ap = AeroProblem(**dict(M6 if rans else EULER, **(ap_changes or {})))
    solver.setAeroProblem(ap)
    w0 = perturbed_state(solver) if w0 is None else w0
    solver.setStates(w0)
    cuda_inviscid.LAUNCHES = cuda_rans.LAUNCHES = 0
    t0 = time.perf_counter()
    sens = solver.evalFunctionsSens(ap, {}, funcs)
    info = solver.adjoint_info
    route = "" if solver.cfg.use_kernels else ", no kernels"
    print(f"  {equation} {'x'.join(map(str, ADJ_DIMS))} on {device} "
          f"({solver.dtype}{route}): {time.perf_counter() - t0:.3f} s, last "
          f"adjoint {info.iters} GMRES iterations to rel "
          f"{info.res_norm / info.b_norm:.3e}")
    return sens, solver, cuda_rans.LAUNCHES, cuda_inviscid.LAUNCHES, w0


def compare_totals(label, want, got, names, rtol):
    """Totals of one function on two runs: each of ``names`` and the norm
    of xv, relative to the first run's; returns the largest."""
    worst = 0.0
    for n in names:
        a, b = want[n], got[n]
        err = abs(b - a) / max(abs(a), 1e-300)
        worst = max(worst, err)
        print(f"    {label} d/d{n}: {b!r} vs {a!r}, rel {err:.3e}")
        assert np.isfinite(b)
    na, nb = (float(np.linalg.norm(t["xv"])) for t in (want, got))
    err = abs(nb - na) / na
    worst = max(worst, err)
    entry = (np.abs(got["xv"] - want["xv"]).max()
             / np.abs(want["xv"]).max())
    print(f"    {label} |d/dxv|: {nb!r} vs {na!r}, rel {err:.3e}; largest "
          f"entry difference {entry:.3e} of the largest entry (tolerance "
          f"{rtol:g} on the others)")
    assert np.all(np.isfinite(got["xv"]))
    assert worst < rtol, (label, worst)
    return worst


def dot_identity(solver, seed, rtol):
    """<J v, u> = <v, J^T u> in w and x through
    computeJacobianVectorProductFwd/Bwd, seeded numpy vectors, the dot
    products summed in f64; returns the relative difference."""
    rng = np.random.default_rng(seed)
    wvec, xvec = solver._wx_vecs()
    wd = rng.standard_normal(wvec.shape)
    xd = rng.standard_normal(xvec.shape)
    rbar = rng.standard_normal(wvec.shape)
    rdot = solver.computeJacobianVectorProductFwd(
        wDot=wd, xVDot=xd, residualDeriv=True)
    gw, gx = solver.computeJacobianVectorProductBwd(
        resBar=rbar, wDeriv=True, xVDeriv=True)
    lhs = float(rdot.astype(np.float64) @ rbar)
    rhs = float(gw.astype(np.float64) @ wd + gx.astype(np.float64) @ xd)
    err = abs(lhs - rhs) / abs(lhs)
    print(f"  dot-product identity at {wvec.numel()} states and "
          f"{xvec.numel()} coordinates: <J v, u> {lhs!r}, <v, J^T u> "
          f"{rhs!r}, rel {err:.3e} (tolerance {rtol:g})")
    assert np.isfinite(lhs) and err < rtol
    return err


def adjoint_parity():
    """[15]: the small Euler adjoint through K2 and the small RANS-SA one
    through K1 on the card, against the CPU (f64, plain), and the RANS one
    against the card's plain route; returns the launches of each path."""
    from adflow_torch.ops import cuda_inviscid, cuda_rans

    funcs = ["cl", "cd"]
    cpu, _, _, _, w0 = small_adjoint("euler", "cpu", funcs, **ADJ_EULER_OPTS)
    card, solver, k1, k2, _ = small_adjoint("euler", "cuda:0", funcs, w0,
                                            **ADJ_EULER_OPTS)
    expected = 2 * len(funcs)
    print(f"  K2 launches {k2} (expected {expected}: for each function one "
          f"forward of the residual's vjp in w, built once a solve, and one "
          f"of its vjp in x and the design variables), K1 launches {k1}")
    assert k2 == expected and k1 == 0, (k2, k1)
    for f in funcs:
        compare_totals(f"card vs CPU, {f}", cpu[f"m6e_{f}"],
                       card[f"m6e_{f}"], ("alpha", "mach"), ADJ_EULER_RTOL)
    cuda_inviscid.LAUNCHES = 0
    dot_identity(solver, 1, DOT_RTOL_F32)
    assert cuda_inviscid.LAUNCHES == 2, cuda_inviscid.LAUNCHES

    names = ("alpha", "mach", "reynolds", "T")
    cpu, _, _, _, w0 = small_adjoint("RANS", "cpu", ["cd"], **ADJ_RANS_OPTS)
    card, _, k1_rans, k2_rans, _ = small_adjoint(
        "RANS", "cuda:0", ["cd"], w0, **ADJ_RANS_OPTS)
    route, _, k1_route, k2_route, _ = small_adjoint(
        "RANS", "cuda:0", ["cd"], w0, **ADJ_ROUTE_OPTS)
    plain, _, k1_plain, k2_plain, _ = small_adjoint(
        "RANS", "cuda:0", ["cd"], w0, useBlockettes=False, **ADJ_ROUTE_OPTS)
    print(f"  K1 launches {k1_rans} frozen, {k1_route} unfrozen (expected 2 "
          f"each, as K2's above), K2 {k2_rans}, {k2_route}; without the "
          f"kernels K1 {k1_plain}, K2 {k2_plain}")
    assert (k1_rans, k2_rans, k1_route, k2_route, k1_plain, k2_plain) == (
        2, 0, 2, 0, 0, 0)
    compare_totals("card vs CPU, frozen turbulence, cd", cpu["m6_cd"],
                   card["m6_cd"], names, ADJ_RANS_RTOL)
    compare_totals("K1 vs plain route, unfrozen, cd", plain["m6_cd"],
                   route["m6_cd"], names, ROUTE_RTOL)
    return k1_rans + k1_route, k2


def full_adjoint(solver):
    """[16]: ``evalFunctionsSens`` of cl on the main path's solved wing,
    40 GMRES iterations; its pieces timed, the dot-product identity at
    full width and three GMRES iterations profiled. Returns the K2
    launches of the call."""
    from adflow_torch.adjoint import api as adj
    from adflow_torch.ops import cuda_inviscid, cuda_rans
    from adflow_torch.solvers.krylov import gmres

    for k, v in FULL_ADJ_OPTS.items():
        solver.setOption(k, v)
    ap = solver.curAP
    cuda_inviscid.LAUNCHES = cuda_rans.LAUNCHES = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sens = solver.evalFunctionsSens(ap, {}, ["cl"])[f"{ap.name}_cl"]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    k2, k1 = cuda_inviscid.LAUNCHES, cuda_rans.LAUNCHES
    info = solver.adjoint_info
    rel_res = info.res_norm / info.b_norm
    print(f"  evalFunctionsSens(cl): {wall:.3f} s; {info.iters} GMRES "
          f"iterations to rel {rel_res:.3e}; dcl/dalpha {sens['alpha']!r}, "
          f"dcl/dmach {sens['mach']!r}, |dcl/dxv| "
          f"{float(np.linalg.norm(sens['xv']))!r}")
    print(f"  K2 launches {k2} (expected 2: the vjp in w built once for the "
          f"solve, the vjp in x and the design variables), K1 {k1}")
    assert k2 == 2 and k1 == 0, (k2, k1)
    assert info.iters == FULL_ADJ_OPTS["adjointMaxIter"]
    assert np.isfinite(rel_res) and rel_res < 1.0
    assert all(np.isfinite(sens[k]) for k in ("alpha", "mach"))
    assert np.all(np.isfinite(sens["xv"]))

    fns, nfns = solver._adjoint_fns(), solver._newton_fns()
    wvec, xvec = solver._wx_vecs()
    params = solver._ap_params(ap)
    _, vjp_w = torch.func.vjp(lambda w: fns.res(w, xvec, params), wvec)
    gen = torch.Generator(device=wvec.device).manual_seed(3)
    v = torch.randn(wvec.shape, generator=gen, device=wvec.device)
    precond = adj._transposed_line_pc(nfns, wvec)
    parts = (
        ("transposed PC build", lambda: adj._transposed_line_pc(nfns, wvec),
         3),
        ("transposed PC apply", lambda: precond(v), 10),
        ("one vjp matvec", lambda: vjp_w(v), 10),
    )
    for label, fn, reps in parts:
        print(f"  {label}: {time_ms(fn, reps=reps, warmup=1):.4f} ms "
              f"(median of {reps})")
    dot_identity(solver, 2, DOT_RTOL_F32)

    rhs = torch.func.grad(lambda w: fns.funcs(w, xvec, params)["cl"])(wvec)

    def three_iterations():
        gmres(lambda u: vjp_w(u)[0], rhs, m=3, restarts=1, tol=0.0,
              precond=precond)

    profile_device(three_iterations, "3 adjoint GMRES iterations")
    return k2


def launches():
    """(K1, K2) launch counts."""
    from adflow_torch.ops import cuda_inviscid, cuda_rans
    return cuda_rans.LAUNCHES, cuda_inviscid.LAUNCHES


def zero_launches():
    """K1's, K2's and the smoothing kernel's counters set to 0."""
    from adflow_torch.ops import cuda_inviscid, cuda_irs, cuda_rans
    cuda_inviscid.LAUNCHES = cuda_rans.LAUNCHES = cuda_irs.LAUNCHES = 0


def matrix_path(scalar_pc_ms):
    """[17]: the default ANK solve of the main path's wing with matrix
    dissipation, MATRIX_STEPS steps from the free stream, exactly no kernel
    launch (the JAX package routes matrix dissipation and upwind before
    its kernels); its pieces at the final state beside the scalar PC's of
    [14], the upwind residual there, the peak device memory and one
    profiled step."""
    import dataclasses

    from adflow_torch.api.solver import ADFLOW
    from adflow_torch.core.refstate import AeroProblem
    from adflow_torch.meshgen.analytic import wing_omesh
    from adflow_torch.solvers import newton

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    solver = ADFLOW(options=dict(euler_options(MATRIX_STEPS), **MATRIX),
                    mesh=wing_omesh(ni=FULL_DIMS[0], nj=FULL_DIMS[1],
                                    nk=FULL_DIMS[2]))
    ap = AeroProblem(**EULER)
    solver.setAeroProblem(ap)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    solver(ap)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    funcs = solver.evalFunctions(ap, {})
    info = solver.solve_info
    print_steps(info, "residual evaluations (no kernel)")
    print(f"  {len(info.steps)} ANK steps in {t2 - t1:.3f} s: "
          f"{(t2 - t1) / len(info.steps) * 1e3:.3f} ms per step; "
          f"cl {funcs['m6e_cl']!r}, cd {funcs['m6e_cd']!r}")
    assert solver.dtype == torch.float32
    assert len(info.steps) == MATRIX_STEPS and not info.failed
    assert np.all(np.isfinite(info.history))
    assert np.isfinite(funcs["m6e_cl"]) and np.isfinite(funcs["m6e_cd"])
    assert info.history[-1, 0] < info.total_r0, "residual did not fall"

    opts = solver.options
    fns = newton.build_newton_fns(
        solver.w_list, solver.metrics_list, solver.topo, solver.cfg,
        solver.ref, solver.winf, solver.extras_list)
    wvec = fns.packer.pack_w(solver.w_list)
    cfl = info.steps[-1].cfl
    axes, kappa = newton._pc_params(opts)
    pc = fns.build_pc(wvec, cfl, axes=axes, kappa=kappa)
    v = fns.res_flat(wvec)
    v = v / torch.linalg.norm(v)
    cfg_up = dataclasses.replace(
        solver.cfg, discretization="upwind", riemann_solver="roe",
        limiter="van albada")
    up = newton.build_newton_fns(
        solver.w_list, solver.metrics_list, solver.topo, cfg_up,
        solver.ref, solver.winf, solver.extras_list)
    parts = (
        ("residual (matrix dissipation, plain)",
         lambda: fns.res_flat(wvec), 10),
        ("one jvp matvec (matrix dissipation)",
         lambda: torch.func.jvp(fns.res_flat, (wvec,), (v,)), 10),
        ("characteristic PC build", lambda: fns.build_pc(
            wvec, cfl, axes=axes, kappa=kappa), 3),
        ("characteristic PC apply",
         lambda: newton.pc_apply_vec(pc, fns.packer, v), 10),
        ("upwind residual (Roe, van Albada)", lambda: up.res_flat(wvec), 10),
        ("upwind jvp", lambda: torch.func.jvp(up.res_flat, (wvec,), (v,)),
         10),
    )
    for label, fn, reps in parts:
        print(f"  {label}: {time_ms(fn, reps=reps, warmup=1):.4f} ms "
              f"(median of {reps})")
    print(f"  [14]'s scalar PC at the scalar path's state: build "
          f"{scalar_pc_ms[0]:.4f} ms, apply {scalar_pc_ms[1]:.4f} ms")
    r_up = up.res_flat(wvec)
    assert bool(torch.isfinite(r_up).all())
    step = newton.make_ank_step(fns, opts)
    profile_device(lambda: step(wvec, cfl, pc), "1 ANK step (matrix)")
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2**30
    k1, k2 = launches()
    print(f"  peak device memory {peak:.3f} GiB; K1 launches {k1}, K2 "
          f"launches {k2} (expected 0 and 0: no kernel on this path)")
    assert (k1, k2) == (0, 0), (k1, k2)
    return k1, k2


def small_state(device, mesh, ap, options, w0=None, **kwargs):
    """A solver of ``mesh`` on ``device`` (constructor ``kwargs``) at the
    seeded perturbed free stream of ``ap`` (``w0``, else made here);
    returns (solver, w0)."""
    from adflow_torch.api.solver import ADFLOW
    from adflow_torch.core.refstate import AeroProblem

    solver = ADFLOW(options=options, mesh=mesh, device=device, **kwargs)
    solver.setAeroProblem(AeroProblem(**ap))
    w0 = perturbed_state(solver) if w0 is None else w0
    solver.setStates(w0)
    return solver, w0


def channel_with(kind):
    """The channel of meshgen/analytic.py at CHANNEL_DIMS with its imin
    (an inflow kind) or imax (an outflow kind) face of BC ``kind``, with
    seeded per-subface data where the type takes them."""
    from adflow_torch.core.mesh import BCSubface, BCType, Face
    from adflow_torch.meshgen.analytic import channel_mesh

    g, mach = 1.4, 0.4
    p_inf = 1.0 / g
    u_inf = mach * np.sqrt(g * p_inf)
    nj, nk = CHANNEL_DIMS[1:]
    rng = np.random.default_rng(0)

    def arr(v):
        return v * (1.0 + 0.01 * rng.standard_normal((nj, nk)))

    data = {
        "SUBSONIC_INFLOW": {"rho": 1.02, "vmag": arr(0.9 * u_inf),
                            "dir": np.array([1.0, 0.05, 0.0])},
        "MASS_BLEED_INFLOW": {},
        "DOMAIN_INTERFACE_TOTAL": {
            "Pt": arr(p_inf * (1 + 0.2 * mach ** 2) ** 3.5),
            "Tt": 1 + 0.2 * mach ** 2},
        "DOMAIN_INTERFACE_RHOUVW": {"rho": arr(1.0), "vx": arr(u_inf)},
        "SUPERSONIC_INFLOW": {"rho": arr(1.0), "vx": arr(1.1 * u_inf)},
        "DOMAIN_INTERFACE_ALL": {"rho": 1.01, "P": arr(p_inf)},
        "DOMAIN_INTERFACE_RHO": {"rho": arr(1.0)},
        "MASS_BLEED_OUTFLOW": {"P": arr(p_inf)},
        "DOMAIN_INTERFACE_P": {"P": 0.98 * p_inf},
        "SUPERSONIC_OUTFLOW": {},
        "EXTRAPOLATE": {},
    }[kind]
    mesh = channel_mesh(*CHANNEL_DIMS)
    blk = mesh.blocks[0]
    face = Face.IMAX if "OUTFLOW" in kind or kind in (
        "DOMAIN_INTERFACE_P", "EXTRAPOLATE") else Face.IMIN
    blk.bcs = [sf for sf in blk.bcs if sf.face is not face] + [
        BCSubface(face, getattr(BCType, kind), family="plane", data=data)]
    return mesh


def small_slice_parity():
    """[18]: the upwind and matrix residuals, one matrix ANK step, the
    plate's flow-through functions and each new BC's ghost fill on the
    card (f32) against the CPU (f64), then a precision='mixed' NK solve of
    the Euler wing on the card; returns the K1 and K2 launches of the
    upwind and matrix cases (none) and the K2 launches of the mixed
    solve."""
    import dataclasses

    from adflow_torch.meshgen.analytic import flatplate_mesh, wing_omesh
    from adflow_torch.physics.residual import block_residual
    from adflow_torch.physics.thermo import pressure

    def wing(device, w0=None, **options):
        return small_state(device, wing_omesh(ni=16, nj=8, nk=8), EULER,
                           dict(euler_options(1), **options), w0)

    zero_launches()
    cpu, w0 = wing("cpu")
    card, _ = wing("cuda:0", w0)
    wc, wg = cpu._filled_w()[0], card._filled_w()[0]
    m = cpu.metrics_list[0]
    scale = flux_scale(wc, pressure(wc), (m.siE, m.sjE, m.skE))
    worst = 0.0
    for disc, rs, lim in UPWIND_VARIANTS:
        kw = dict(discretization=disc, riemann_solver=rs, limiter=lim)
        rc = block_residual(wc, m, dataclasses.replace(cpu.cfg, **kw),
                            cpu.ref, por=cpu.topo.blocks[0].por)
        rg = block_residual(wg, card.metrics_list[0],
                            dataclasses.replace(card.cfg, **kw), card.ref,
                            por=card.topo.blocks[0].por)
        err = float(((rg.double().cpu() - rc).abs().amax(dim=(0, 1, 2))
                     / scale).max())
        worst = max(worst, err)
        print(f"  {disc}, {rs}, {lim}: residual card vs CPU {err:.3e} of "
              f"the flux scale (tolerance {FLUX_RTOL:g})")
        assert bool(torch.isfinite(rg).all()) and err < FLUX_RTOL
    assert launches() == (0, 0), launches()

    small_ank_parity(1, MATRIX)
    k1_small, k2_small = launches()
    print(f"  upwind and matrix residuals and the matrix ANK step: K1 "
          f"launches {k1_small}, K2 launches {k2_small} (expected 0 and 0)")
    assert (k1_small, k2_small) == (0, 0), (k1_small, k2_small)

    runs, w0 = [], None
    for device in ("cpu", "cuda:0"):
        s, w0 = small_state(
            device, flatplate_mesh(ni=16, nj=12),
            dict(name="fp", mach=0.3, alpha=0.0, reynolds=1e6,
                 reynoldsLength=1.0, T=300.0),
            dict(euler_options(1), equationType="RANS"), w0)
        runs.append(s.evalFunctions(s.curAP, {}, FLOW_FUNCS + ["cd"]))
    fc, fg = runs
    f_rel = max(abs(fg[k] - fc[k]) / abs(fc[k]) for k in fc)
    print(f"  plate 16x12, flow-through functions card vs CPU: rel "
          f"{f_rel:.3e} (tolerance {FLOW_RTOL:g}); mdot {fg['fp_mdot']!r} "
          f"vs {fc['fp_mdot']!r}")
    assert len(fc) == len(fg) == len(FLOW_FUNCS) + 1 and f_rel < FLOW_RTOL

    for kind in ("SUBSONIC_INFLOW", "MASS_BLEED_INFLOW",
                 "DOMAIN_INTERFACE_TOTAL", "DOMAIN_INTERFACE_RHOUVW",
                 "SUPERSONIC_INFLOW", "DOMAIN_INTERFACE_ALL",
                 "DOMAIN_INTERFACE_RHO", "MASS_BLEED_OUTFLOW",
                 "DOMAIN_INTERFACE_P", "SUPERSONIC_OUTFLOW", "EXTRAPOLATE"):
        fills, w0 = [], None
        for device in ("cpu", "cuda:0"):
            s, w0 = small_state(device, channel_with(kind),
                                dict(name="ch", mach=0.4), euler_options(1),
                                w0)
            fills.append(s._filled_w()[0].double().cpu())
        err = float((fills[1] - fills[0]).abs().max()
                    / fills[0].abs().max())
        print(f"  channel {'x'.join(map(str, CHANNEL_DIMS))}, {kind}: ghost "
              f"fill card vs CPU {err:.3e} of the largest entry (tolerance "
              f"{BC_RTOL:g})")
        assert bool(torch.isfinite(fills[1]).all()) and err < BC_RTOL

    zero_launches()
    solver, _ = wing("cuda:0", **MIXED_WING_OPTS)
    t0 = time.perf_counter()
    solver(solver.curAP)
    torch.cuda.synchronize()
    info = solver.solve_info
    hand, f32_evals = mixed_phases(info)
    k1, k2 = launches()
    print(f"  precision='mixed' NK solve, Euler wing 16x8x8 on the card: "
          f"{time.perf_counter() - t0:.3f} s, {len(info.steps)} steps, "
          f"R/R0 {info.total_r_final / info.total_r0:.3e}; handover to f64 "
          f"after step {hand}; K2 launches {k2}: f32 phase {2 + f32_evals} "
          f"expected, f64 phase {k2 - 2 - f32_evals}; K1 {k1}")
    assert info.converged and not info.failed
    assert k2 == 2 + f32_evals and k1 == 0, (k1, k2, f32_evals)
    return k1_small, k2_small, k2


def mixed_phases(info):
    """(the steps of the f32 phase, their residual evaluations) of a
    precision='mixed' solve; the f64 continuation must have followed."""
    kinds = [str(r.dtype) for r in info.steps]
    hand = kinds.index("torch.float64")
    assert hand > 0 and set(kinds[:hand]) == {"torch.float32"}, kinds
    return hand, sum(r.res_evals for r in info.steps[:hand])


def plate_solver(device, precision, l2conv):
    """[19]'s plate on ``device`` with ``precision``, NK on, to ``l2conv``
    of the free-stream residual, its aero problem set."""
    from adflow_torch.api.solver import ADFLOW
    from adflow_torch.core.refstate import AeroProblem
    from adflow_torch.meshgen.analytic import flatplate_mesh

    solver = ADFLOW(options=dict(PLATE_OPTS, precision=precision,
                                 L2Convergence=l2conv),
                    mesh=flatplate_mesh(ni=PLATE_DIMS[0], nj=PLATE_DIMS[1]),
                    device=device)
    solver.setAeroProblem(AeroProblem(**PLATE))
    return solver


def plate_answer(solver):
    """cd, the flow-through functions and the mid-plate skin friction from
    the first cell off the wall (as tests/test_solve_rans.py takes it)."""
    out = solver.evalFunctions(solver.curAP, {}, ["cd"] + FLOW_FUNCS)
    w = solver._filled_w()[0].double().cpu()
    xc = solver.metrics_list[0].xc_ext[1:-1, 1:-1, 1:-1].double().cpu()
    wi = w[2:-2, 2:-2, 2:-2]
    i_x = int(torch.argmin((xc[:, 0, 0, 0] - 0.5).abs()))
    u1 = float(wi[i_x, 0, 0, 1] / wi[i_x, 0, 0, 0])
    out["cf"] = (solver.ref.mu_inf * u1 / float(xc[i_x, 0, 0, 1])
                 / (0.5 * PLATE["mach"] ** 2))
    return out


def plate_reference():
    """[19]'s float64 reference on the CPU, run in a process of its own:
    (answer, free-stream residual norm, R/R0, steps, wall s)."""
    torch.set_num_threads(PLATE_REF_THREADS)
    solver = plate_solver("cpu", "float64", PLATE_REF_CONV)
    t0 = time.perf_counter()
    solver(solver.curAP)
    info = solver.solve_info
    assert info.converged and not info.failed
    return (plate_answer(solver), info.total_r0,
            info.total_r_final / info.total_r0, len(info.steps),
            time.perf_counter() - t0)


def residual_norm(solver, states):
    """The norm of the residual at ``states`` that the Newton driver
    measures, evaluated by ``solver`` (its device and dtype)."""
    from adflow_torch.solvers import newton

    solver.setStates(states)
    fns = newton.build_newton_fns(
        solver.w_list, solver.metrics_list, solver.topo, solver.cfg,
        solver.ref, solver.winf, solver.extras_list)
    return float(torch.linalg.norm(fns.res_flat(fns.packer.pack_w(
        solver.w_list))))


def plate_mixed(reference):
    """[19]: the plate with precision='mixed' and NK converged on the card,
    K1 in the f32 phase only; the f64 residual of its answer on the CPU and
    the answer against ``reference``, the future of ``plate_reference``
    (started before [18], so that it runs while the card works). Returns
    the K1 launches."""
    l2conv = PLATE_OPTS["L2Convergence"]
    zero_launches()
    solver = plate_solver("cuda:0", "mixed", l2conv)
    t0 = time.perf_counter()
    solver(solver.curAP)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    k1, k2 = launches()
    info = solver.solve_info
    hand, f32_evals = mixed_phases(info)
    got = plate_answer(solver)
    print(f"  plate {'x'.join(map(str, PLATE_DIMS))}, Re "
          f"{PLATE['reynolds']:g}, precision='mixed' on the card: "
          f"{wall:.3f} s, {len(info.steps)} steps ({hand} f32, "
          f"{len(info.steps) - hand} f64; "
          f"{[r.kind for r in info.steps].count('NK')} NK), R/R0 "
          f"{info.total_r_final / info.total_r0:.3e}, converged "
          f"{info.converged}; handover to f64 after step {hand}; K1 "
          f"launches {k1}: f32 phase {2 + f32_evals} expected, f64 "
          f"phase {k1 - 2 - f32_evals}; K2 {k2}")
    assert info.converged and not info.failed
    assert info.total_r_final < l2conv * info.total_r0
    assert k1 == 2 + f32_evals > 2 and k2 == 0, (k1, k2, f32_evals)
    want, r_free, ref_drop, ref_steps, ref_wall = reference.result()
    print(f"  float64 on the CPU (a process of its own, "
          f"{PLATE_REF_THREADS} threads): {ref_wall:.3f} s, {ref_steps} "
          f"steps, R/R0 {ref_drop:.3e}")
    r_ans = residual_norm(plate_solver("cpu", "float64", l2conv),
                          solver.getStates().double().cpu())
    print(f"  the card's answer, its f64 residual on the CPU: "
          f"{r_ans / r_free:.3e} of the free-stream residual (tolerance "
          f"{PLATE_CONV:g})")
    assert r_ans < PLATE_CONV * r_free
    worst = 0.0
    for key in want:
        err = abs(got[key] - want[key]) / abs(want[key])
        worst = max(worst, err)
        print(f"    {key}: card {got[key]!r}, CPU float64 {want[key]!r}, "
              f"rel {err:.3e}")
    print(f"  card (mixed) against CPU (float64): rel {worst:.3e} "
          f"(tolerance {PLATE_RTOL:g})")
    assert len(got) == len(want) == len(FLOW_FUNCS) + 2
    assert worst < PLATE_RTOL
    return k1


def sst_path(scalar_pc_ms):
    """[20]: the default ANK solve of the main path's mesh, viscous, with
    RANS and SST, SST_STEPS steps from the free stream: exactly no K1
    launch and K2 for every residual evaluation (the mean flow of a block
    K1 declines); its pieces at the final state beside the SA-free scalar
    PC of [14], the peak device memory, and one jvp matvec plus one PC
    apply under the profiler. Returns the K2 launches."""
    from adflow_torch.api.solver import ADFLOW
    from adflow_torch.core.refstate import AeroProblem
    from adflow_torch.meshgen.analytic import wing_omesh
    from adflow_torch.physics.residual import block_residual
    from adflow_torch.solvers import newton

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    solver = ADFLOW(options=dict(solver_options(SST_STEPS), **SST_OPTS),
                    mesh=wing_omesh(ni=FULL_DIMS[0], nj=FULL_DIMS[1],
                                    nk=FULL_DIMS[2], viscous=True))
    ap = AeroProblem(**M6)
    solver.setAeroProblem(ap)
    torch.cuda.synchronize()
    zero_launches()
    t1 = time.perf_counter()
    solver(ap)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    k1, k2 = launches()
    funcs = solver.evalFunctions(ap, {})
    info = solver.solve_info
    print_steps(info)
    expected = 2 + sum(r.res_evals for r in info.steps)
    print(f"  {len(info.steps)} ANK steps in {t2 - t1:.3f} s: "
          f"{(t2 - t1) / len(info.steps) * 1e3:.3f} ms per step; Krylov "
          f"iterations {[int(r.stats[4]) for r in info.steps]}; cl "
          f"{funcs['m6_cl']!r}, cd {funcs['m6_cd']!r}")
    print(f"  K2 launches {k2} (expected {expected}: 2 for the Newton "
          f"driver's free-stream and starting norms + the steps' residual "
          f"evaluations), K1 launches {k1} (expected 0: K1 is SA's)")
    assert solver.dtype == torch.float32 and solver.ref.nw == 7
    assert len(info.steps) == SST_STEPS and not info.failed
    assert np.all(np.isfinite(info.history))
    assert np.isfinite(funcs["m6_cl"]) and np.isfinite(funcs["m6_cd"])
    assert k2 == expected and k1 == 0, (k1, k2)

    opts = solver.options
    fns = newton.build_newton_fns(
        solver.w_list, solver.metrics_list, solver.topo, solver.cfg,
        solver.ref, solver.winf, solver.extras_list)
    wvec = fns.packer.pack_w(solver.w_list)
    cfl = info.steps[-1].cfl
    axes, kappa = newton._pc_params(opts)
    pc = fns.build_pc(wvec, cfl, axes=axes, kappa=kappa)
    v = fns.res_flat(wvec)
    v = v / torch.linalg.norm(v)
    wf = solver._filled_w()[0]
    m, ex, por = (solver.metrics_list[0], solver.extras_list[0],
                  solver.topo.blocks[0].por)
    parts = (
        ("SST block_residual (K2 + plain viscous and SST)",
         lambda: block_residual(wf, m, solver.cfg, solver.ref, ex, por=por),
         5),
        ("one jvp matvec (SST)",
         lambda: torch.func.jvp(fns.res_flat, (wvec,), (v,)), 3),
        ("7-equation line PC build", lambda: fns.build_pc(
            wvec, cfl, axes=axes, kappa=kappa), 3),
        ("7-equation line PC apply",
         lambda: newton.pc_apply_vec(pc, fns.packer, v), 10),
    )
    zero_launches()
    for label, fn, reps in parts:
        print(f"  {label}: {time_ms(fn, reps=reps, warmup=1):.4f} ms "
              f"(median of {reps})")
    print(f"  [14]'s scalar PC (Euler, 5 equations): build "
          f"{scalar_pc_ms[0]:.4f} ms, apply {scalar_pc_ms[1]:.4f} ms")
    assert launches()[0] == 0, launches()

    def matvec_and_pc():
        newton.pc_apply_vec(pc, fns.packer,
                            torch.func.jvp(fns.res_flat, (wvec,), (v,))[1])

    profile_device(matvec_and_pc, "one jvp matvec and one PC apply (SST)")
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"  peak device memory {peak:.3f} GiB")
    return k2


def _on_cpu(x):
    """Tensors, metrics, dicts and tuples of them, copied to the CPU."""
    if torch.is_tensor(x):
        return x.cpu()
    if isinstance(x, dict):
        return {k: _on_cpu(v) for k, v in x.items()}
    if isinstance(x, tuple):
        return type(x)(*(_on_cpu(v) for v in x)) if hasattr(x, "_fields") \
            else tuple(_on_cpu(v) for v in x)
    return x


def small_residual(label, mesh, ap, options, want_launches, setup=None):
    """The block residual of ``mesh`` at the seeded perturbed free stream
    on the card (f32), after ``setup`` of each solver; the card's K1 and K2
    launches must be ``want_launches``. Returns them.

    The mean-flow rows are held to the CPU's f64 residual, of the flux
    scale: the largest mean-flow face flux, one number, as the CPU tests
    take it (at M 0.05 the mass flux is 1e-2 of the pressure terms that
    round in f32). A turbulence row near a wall is a difference of terms
    far larger than itself, computed on f32 metrics whose first cells
    (1e-6 thick at coordinates of order 1) are off their f64 values by
    percents; so every row is also held to the plain version in f32 on the
    CPU, on the card's own inputs, turbulence rows per the larger of their
    row-scaled advective flux and their largest entry, and the turbulence
    rows' distance from f64 is printed."""
    from adflow_torch.physics.residual import block_residual
    from adflow_torch.physics.thermo import pressure

    cpu, w0 = small_state("cpu", mesh(), ap, options)
    card, _ = small_state("cuda:0", mesh(), ap, options, w0)
    for s in (cpu, card):
        if setup is not None:
            setup(s)

    def residual(s, on_cpu=False):
        args = (s._filled_w()[0], s.metrics_list[0], s.cfg, s.ref,
                s.extras_list[0] if s.extras_list else None,
                s.topo.blocks[0].por)
        if on_cpu:
            args = _on_cpu(args)
        return block_residual(*args[:5], por=args[5])

    r64 = residual(cpu)
    zero_launches()
    rg = residual(card)
    torch.cuda.synchronize()
    got_launches = launches()
    r32 = residual(card, on_cpu=True).double()
    rg = rg.double().cpu()
    wc = cpu._filled_w()[0]
    m = cpu.metrics_list[0]
    scale = flux_scale(wc, pressure(wc), (m.siE, m.sjE, m.skE),
                       turb_scales=cpu.cfg.turb_scales)
    scale = torch.cat([scale[:5].max().expand(5), torch.maximum(
        scale[5:], r32.abs().amax(dim=(0, 1, 2))[5:])])
    err64 = ((rg - r64).abs().amax(dim=(0, 1, 2)) / scale).tolist()
    err32 = ((rg - r32).abs().amax(dim=(0, 1, 2)) / scale).tolist()
    print(f"  {label}: residual card vs CPU f64 (mean flow), per channel of "
          f"the flux scale {[f'{e:.2e}' for e in err64[:5]]}; card vs the "
          f"plain f32 version {[f'{e:.2e}' for e in err32]} (tolerance "
          f"{FLUX_RTOL:g}); turbulence rows vs f64 "
          f"{[f'{e:.2e}' for e in err64[5:]]}; K1, K2 launches "
          f"{got_launches} (expected {want_launches})")
    assert bool(torch.isfinite(rg).all())
    assert max(err64[:5]) < FLUX_RTOL and max(err32) < FLUX_RTOL
    assert got_launches == want_launches, (label, got_launches)
    return got_launches


def small_physics_parity():
    """[21]: the slice's options on small cases, card (f32) against the CPU
    (f64) from the seeded perturbation, with exact launch counts; one ANK
    step with grid motion and one with the low-speed preconditioner; the
    grid-motion totals of ``evalFunctionsSens``. Returns the K1 and K2
    launches."""
    from adflow_torch.meshgen.analytic import (
        channel_mesh, flatplate_mesh, wing_omesh)

    def wing(viscous):
        return lambda: wing_omesh(ni=16, nj=8, nk=8, viscous=viscous)

    plate = PLATE_SMALL
    k1 = k2 = 0
    for label, options in (
            ("SST", {"turbulenceModel": "SST"}),
            ("rotation-SA", {"useRotationSA": True}),
            ("SA-Edwards", {"turbulenceModel": "SA-Edwards"}),
            ("QCR", {"useQCR": True}),
            ("second-order SA advection", {"turbulenceOrder":
                                           "second order"})):
        a, b = small_residual(f"RANS wing 16x8x8, {label}", wing(True), M6,
                              dict(solver_options(1), **options), (0, 1))
        k1, k2 = k1 + a, k2 + b
    a, b = small_residual(
        "plate 16x12, SA with wall functions",
        lambda: flatplate_mesh(ni=16, nj=12), plate,
        dict(solver_options(1), useWallFunctions=True), (1, 0))
    k1, k2 = k1 + a, k2 + b
    a, b = small_residual(
        "Euler wing 16x8x8, rotRate + machGrid", wing(False),
        dict(EULER, **GRID_MOTION), euler_options(1), (0, 0))
    k1, k2 = k1 + a, k2 + b
    a, b = small_residual(
        "Euler wing 16x8x8, low-speed preconditioner at M 0.05",
        wing(False), dict(EULER, mach=0.05),
        dict(euler_options(1), lowSpeedPreconditioner=True), (0, 0))
    k1, k2 = k1 + a, k2 + b

    def disk(solver):
        solver.addActuatorRegion([1.4, 0.5, 0.1], [1.6, 0.5, 0.1],
                                 radius=10.0, thrust=0.01, torque=0.002)

    a, b = small_residual(
        "Euler channel 16x8x2, actuator disk (thrust and torque)",
        lambda: channel_mesh(*CHANNEL_DIMS), dict(name="ch", mach=0.3),
        euler_options(1), (0, 1), setup=disk)
    k1, k2 = k1 + a, k2 + b

    for options, changes in (({}, GRID_MOTION),
                             ({"lowSpeedPreconditioner": True},
                              {"mach": 0.05})):
        zero_launches()
        small_ank_parity(1, options, changes)
        print(f"  K1, K2 launches on the card {launches()} (expected "
              f"(0, 0))")
        assert launches() == (0, 0), launches()

    funcs = ["cl"]
    cpu, _, _, _, w0 = small_adjoint("euler", "cpu", funcs,
                                     ap_changes=GRID_MOTION,
                                     **ADJ_EULER_OPTS)
    card, _, a, b, _ = small_adjoint("euler", "cuda:0", funcs, w0,
                                     ap_changes=GRID_MOTION,
                                     **ADJ_EULER_OPTS)
    print(f"  K1, K2 launches {(a, b)} (expected (0, 0): grid motion "
          f"keeps both kernels off)")
    assert (a, b) == (0, 0), (a, b)

    def grid_totals(t):
        t = t["m6e_cl"]
        return {"alpha": t["alpha"], "machGrid": t["machGrid"],
                "rotRate_z": float(t["rotRate"][2]),
                "rotCenter_x": float(t["rotCenter"][0]), "xv": t["xv"]}

    compare_totals("card vs CPU, grid motion, cl", grid_totals(cpu),
                   grid_totals(card),
                   ("alpha", "machGrid", "rotRate_z", "rotCenter_x"),
                   ADJ_EULER_RTOL)
    return k1, k2


def bc_pass_checks(name):
    """[31]: the BC pass kernel (``cuda_bc.fused_bc_pass``) and its jvp in
    the state on the main path's wing at FULL_DIMS, for 5 (Euler) and 6
    (SA) channels, each against the plain pass in float64 on the same
    float32 inputs: every ghost within FULL_RTOL of its channel's largest
    magnitude (the plain float32 pass's distance printed beside it); two
    passes bitwise equal; the kernel's registers and its times (Euler, the
    ANK path's; its jvp the matvec's). Returns its launches and times."""
    from adflow_torch.ops import _nvcc, cuda_bc

    n0 = cuda_bc.LAUNCHES
    for line in _nvcc.ptxas_report(cuda_bc.SRC):
        print(f"  {line}")
    for nw in (6, 5):
        w, m, ops, ref, winf = cuda_bc.sample_pass(FULL_DIMS, nw, "cuda:0")
        gen = torch.Generator(device=w.device).manual_seed(nw)
        v = torch.randn(w.shape, generator=gen, device=w.device)
        m64 = m._replace(siE=m.siE.double(), sjE=m.sjE.double(),
                         skE=m.skE.double())

        def jvp(pass_fn, w, m, winf, v):
            return torch.func.jvp(
                lambda u: pass_fn(u, m, ops, ref, winf), (w,), (v,))[1]

        got = cuda_bc.fused_bc_pass(w, m, ops, ref, winf)
        again = cuda_bc.fused_bc_pass(w, m, ops, ref, winf)
        tan = jvp(cuda_bc.fused_bc_pass, w, m, winf, v)
        plain32 = cuda_bc.bc_pass_reference(w, m, ops, ref, winf)
        exact = cuda_bc.bc_pass_reference(w.double(), m64, ops, ref,
                                          winf.double())
        exact_tan = jvp(cuda_bc.bc_pass_reference, w.double(), m64,
                        winf.double(), v.double())
        torch.cuda.synchronize()
        rel, abs_err = rel_errors(exact, got)
        rel_tan, _ = rel_errors(exact_tan, tan)
        rel_plain, _ = rel_errors(exact, plain32)
        same = bool(torch.equal(got, again))
        print(f"  BC pass at {'x'.join(map(str, FULL_DIMS))}, nw {nw}: "
              f"kernel vs float64 plain per-channel rel err "
              f"{max(rel):.3e} (plain float32 {max(rel_plain):.3e}), max "
              f"abs err {abs_err:.3e}; tangent {max(rel_tan):.3e} "
              f"(tolerance {FULL_RTOL:g}); two passes bitwise equal {same}")
        assert bool(torch.isfinite(got).all() and torch.isfinite(tan).all())
        assert max(rel) < FULL_RTOL and max(rel_tan) < FULL_RTOL, \
            (rel, rel_tan)
        assert same, "BC kernel passes differ"
    launches = cuda_bc.LAUNCHES - n0
    # per pass: the clone and one launch a subface; the jvp clones both
    times = kernel_times("BC pass", cuda_bc.fused_bc_pass,
                         cuda_bc.bc_pass_reference, (w, m),
                         (ops, ref, winf), cuda_bc.min_bytes(w), 0, name)
    times["jvp_ms"] = time_ms(lambda: jvp(cuda_bc.fused_bc_pass, w, m,
                                          winf, v))
    times["plain_jvp_ms"] = time_ms(lambda: jvp(cuda_bc.bc_pass_reference,
                                                w, m, winf, v))
    print(f"  BC pass jvp {times['jvp_ms']:.4f} ms, plain jvp "
          f"{times['plain_jvp_ms']:.4f} ms")
    return launches, times


def mg_kernel_checks():
    """[32]: K1's coarse instantiation and the smoothing kernel at the
    three levels' dims (``mg_timing.LEVELS``) against their float64 plain
    versions, timed. Returns (K1 launches, smoothing launches, the
    smoothing's readings by level, K1 coarse's readings by level)."""
    from adflow_torch.ops import _nvcc, cuda_irs, cuda_rans, mg_timing

    for line in _nvcc.ptxas_report(cuda_irs.SRC):
        print(f"  {line}")
    zero_launches()
    device = torch.device("cuda", 0)
    k1_times, irs_times = {}, {}
    for dims in mg_timing.LEVELS:
        key = "x".join(map(str, dims))
        k1_times[key] = mg_timing.k1_coarse(dims, device)
        irs_times[key] = mg_timing.smoothing(dims, device)
    return cuda_rans.LAUNCHES, cuda_irs.LAUNCHES, irs_times, k1_times


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


# ---------------------------------------------------------------------------
# [22]-[25]: the other solvers (multigrid, DADI, the AMG preconditioner,
# unsteady, time spectral)
# ---------------------------------------------------------------------------

# [22]'s seconds a '3w' cycle on the H100 when the coarse levels ran the
# plain residual and the plain smoothing sweeps
MG_CYCLE_S_PLAIN = 3.45


def mg_by_level(opts, rk_stages_only=False):
    """Residual evaluations, each a K1 launch (or with ``rk_stages_only``
    the RK stages, each a smoothing), of one FAS cycle of ``opts`` on each
    level, finest first: the benchmark's launch rule
    (``benchmark/drivers/mg.py``), with the program's coarsest
    iterations."""
    from benchmark import harness
    rule = harness.driver_module("mg")
    return rule.evaluations_by_level(opts, rule.n_coarsest(),
                                     rk_stages_only)


class K1ByLevel:
    """Counts K1's launches by block dims and instantiation, wrapping
    ``cuda_rans.fused_rans_residual`` (which ``physics/residual.py`` looks
    up at each call) while in use, a graph's replays credited by
    ``ReplayCredit``."""

    def __enter__(self):
        from adflow_torch.ops import cuda_rans
        self.mod, self.orig, self.counts = cuda_rans, \
            cuda_rans.fused_rans_residual, collections.Counter()

        def counted(*args, coarse=False, **kw):
            key = ("x".join(str(n - 4) for n in args[0].shape[:3]),
                   "coarse" if coarse else "fine")
            self.counts[key] += 1
            return self.orig(*args, coarse=coarse, **kw)

        cuda_rans.fused_rans_residual = counted
        self.credit = ReplayCredit(self.counts).__enter__()
        return self

    def __exit__(self, *exc):
        self.credit.__exit__(*exc)
        self.mod.fused_rans_residual = self.orig


def fmg_evals(infos):
    """Residual evaluations of the full-multigrid start: per coarse level
    solved, the Newton driver's free-stream and starting norms and five
    RK stages an iteration (useANKSolver off)."""
    return sum(2 + RK_STAGES * i.iterations for i in infos)


def drop_per_cycle(hist):
    """The geometric mean factor of the mean-flow residual a cycle."""
    return float((hist[-1, 0] / hist[0, 0]) ** (1.0 / max(len(hist) - 1, 1)))


def mg_path(rk_summary):
    """[22]: the full-multigrid start and MG_CYCLES '3w' cycles of the RK
    path's RANS-SA wing through ADFLOW: K1 exactly on every level's
    evaluations (the coarse levels through its coarse instantiation) and
    the start's coarse solves (which run the fine configuration), K2
    never, the smoothing kernel 3 launches a stage; one cycle under the
    profiler; then the DADI smoother on the same wing, one K1 launch an
    iteration. Returns the K1 launches of the multigrid run by level and
    instantiation ({"<dims>_<fine|coarse>": launches}), its smoothing
    launches and the K1 launches of the DADI run."""
    from adflow_torch.api.solver import ADFLOW
    from adflow_torch.core.refstate import AeroProblem
    from adflow_torch.meshgen.analytic import wing_omesh
    from adflow_torch.ops import cuda_irs
    from adflow_torch.solvers import multigrid as mg

    mesh = wing_omesh(ni=FULL_DIMS[0], nj=FULL_DIMS[1], nk=FULL_DIMS[2],
                      viscous=True)
    solver = ADFLOW(options=dict(solver_options(MG_CYCLES),
                                 nCyclesCoarse=MG_COARSE_CYCLES, **MG_OPTS),
                    mesh=mesh)
    ap = AeroProblem(**M6)
    solver.setAeroProblem(ap)
    start = {}
    fmg_start = solver._fmg_start

    def timed_start(opt):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fmg_start(opt)
        torch.cuda.synchronize()
        start["s"] = time.perf_counter() - t0

    solver._fmg_start = timed_start
    torch.cuda.synchronize()
    zero_launches()
    with K1ByLevel() as by_level:
        t1 = time.perf_counter()
        solver(ap)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
    k1, k2 = launches()
    irs = cuda_irs.LAUNCHES
    funcs = solver.evalFunctions(ap, {})
    info, fmg = solver.solve_info, solver.fmg_info
    hist = info.history
    opts = solver.options
    evals, stages = mg_by_level(opts), mg_by_level(opts, True)
    # the start solves the coarsest level first, then each finer one
    levels = " and ".join(
        f"{'x'.join(str(d // 2 ** (len(evals) - 1 - i)) for d in FULL_DIMS)}: "
        f"{f.iterations} RK iterations, R {f.total_r0:.4e} -> "
        f"{f.total_r_final:.4e}{' (failed)' if f.failed else ''}"
        for i, f in enumerate(fmg))
    print(f"  full-multigrid start {start['s']:.3f} s; {levels}"
          f"{'; the free stream kept' if fmg[-1].failed else ''}")
    cyc_s = (t2 - t1 - start["s"]) / info.iterations
    for it in range(info.iterations):
        print(f"  cycle {it + 1:3d}: resrho {hist[it, 0]:.6e} resturb "
              f"{hist[it, 1]:.6e}")
    print(f"  {info.iterations} W-cycles in {t2 - t1 - start['s']:.3f} s: "
          f"{cyc_s * 1e3:.3f} ms per cycle ({MG_CYCLE_S_PLAIN} s with the "
          f"coarse levels plain), residual drop "
          f"{drop_per_cycle(hist):.4f} per cycle ([5]'s RK: "
          f"{rk_summary['ms']:.3f} ms per cycle, drop "
          f"{rk_summary['drop']:.4f} per cycle)")
    print(f"  cl {funcs['m6_cl']!r}, cd {funcs['m6_cd']!r}")
    per_cycle = sum(evals)
    expected = fmg_evals(fmg) + per_cycle * info.iterations
    irs_expected = 3 * sum(stages) * info.iterations
    # the cycles' launches by level (the coarse instantiation below the
    # fine level), the start's at its levels' dims with the fine one
    dims = ["x".join(str(d // 2 ** lev) for d in FULL_DIMS)
            for lev in range(len(evals))]
    want_by_level = {(dims[lev], "coarse" if lev else "fine"):
                     n * info.iterations for lev, n in enumerate(evals)}
    for i, f in enumerate(fmg):
        key = (dims[len(evals) - 1 - i], "fine")
        want_by_level[key] = want_by_level.get(key, 0) + fmg_evals([f])
    print(f"  K1 launches {k1} (expected {expected}: the start's "
          f"{fmg_evals(fmg)} = sum over its coarse levels of 2 + "
          f"{RK_STAGES} x RK iterations, + {per_cycle} evaluations a cycle "
          f"on the levels {evals}, RK stages {stages} and the forced "
          f"and restricted residuals), K2 launches {k2} (expected 0); "
          f"smoothing launches {irs} (expected {irs_expected}: 3 a stage)")
    for key in sorted(set(by_level.counts) | set(want_by_level)):
        print(f"  K1 at {key[0]}, {key[1]} instantiation: "
              f"{by_level.counts.get(key, 0)} launches (expected "
              f"{want_by_level.get(key, 0)})")
    # the start solves the coarsest level, then the next, and keeps the
    # free stream once a level fails
    assert solver.dtype == torch.float32 and len(fmg) in (1, 2)
    assert len(fmg) == 2 or fmg[0].failed
    assert hist.shape == (MG_CYCLES, 2) and np.all(np.isfinite(hist))
    assert np.isfinite(funcs["m6_cl"]) and np.isfinite(funcs["m6_cd"])
    assert k1 == expected and k2 == 0, (k1, expected, k2)
    assert by_level.counts == want_by_level, (by_level.counts,
                                              want_by_level)
    assert irs == irs_expected, (irs, irs_expected)

    levels_ = solver._mg_levels(3)
    irs_eps = max(float(opts["smoothParameter"]) - 1.0, 0.0)
    profile_device(lambda: mg.fas_cycle(
        solver.w_list, levels_, solver.cfg, solver.ref, solver.winf,
        float(opts["CFL"]), cycle="w", irs_eps=irs_eps,
        cfl_coarse=float(opts["CFLCoarse"]),
        vis2_coarse=float(opts["vis2Coarse"]),
        coarse_disc=str(opts["coarseDiscretization"])),
        "one 3w cycle", "rans_residual_kernel", host_ops=False)
    del solver, levels_

    solver = ADFLOW(options=dict(solver_options(DADI_CYCLES),
                                 smoother="DADI"), mesh=mesh)
    solver.setAeroProblem(ap)
    torch.cuda.synchronize()
    zero_launches()
    t1 = time.perf_counter()
    solver(ap)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    k1_dadi, k2_dadi = launches()
    info = solver.solve_info
    print(f"  DADI: {info.iterations} iterations (nCycles {DADI_CYCLES}, "
          f"one chunk) in {t2 - t1:.3f} s: "
          f"{(t2 - t1) / info.iterations * 1e3:.3f} ms per iteration; "
          f"resrho {info.history[0, 0]:.6e} -> {info.history[-1, 0]:.6e}; "
          f"K1 launches {k1_dadi} (expected {info.iterations}: one an "
          f"iteration), K2 {k2_dadi}")
    assert np.all(np.isfinite(info.history))
    assert k1_dadi == info.iterations and k2_dadi == 0, (k1_dadi, k2_dadi)
    return ({f"{d}_{kind}": n for (d, kind), n in by_level.counts.items()},
            irs, k1_dadi)


def amg_path(scalar_pc_ms):
    """[23]: AMG_STEPS ANK steps of the main path's Euler wing from the
    free stream with the multigrid (AMG) preconditioner, K2 exactly as in
    [12]; the AMG PC's build and apply timed beside [14]'s line PC; the
    peak device memory; then ``evalFunctionsSens(cl)`` with the transposed
    multigrid PC, AMG_ADJ_ITERS GMRES iterations, K2 exactly 2. Returns the
    K2 launches of the ANK steps and of the adjoint."""
    from adflow_torch.api.solver import ADFLOW
    from adflow_torch.core.refstate import AeroProblem
    from adflow_torch.meshgen.analytic import wing_omesh
    from adflow_torch.solvers import newton

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    solver = ADFLOW(options=dict(euler_options(AMG_STEPS), **AMG_OPTS),
                    mesh=wing_omesh(ni=FULL_DIMS[0], nj=FULL_DIMS[1],
                                    nk=FULL_DIMS[2]))
    ap = AeroProblem(**EULER)
    solver.setAeroProblem(ap)
    torch.cuda.synchronize()
    zero_launches()
    t1 = time.perf_counter()
    solver(ap)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    k1, k2 = launches()
    info = solver.solve_info
    print_steps(info)
    expected = 2 + sum(r.res_evals for r in info.steps)
    print(f"  {len(info.steps)} ANK steps with the multigrid PC in "
          f"{t2 - t1:.3f} s: {(t2 - t1) / len(info.steps) * 1e3:.3f} ms per "
          f"step; Krylov iterations "
          f"{[int(r.stats[4]) for r in info.steps]}")
    print(f"  K2 launches {k2} (expected {expected}: [12]'s formula), K1 "
          f"{k1}")
    assert len(info.steps) == AMG_STEPS and not info.failed
    assert np.all(np.isfinite(info.history))
    assert k2 == expected and k1 == 0, (k2, expected, k1)

    opts = solver.options
    fns = newton.build_newton_fns(
        solver.w_list, solver.metrics_list, solver.topo, solver.cfg,
        solver.ref, solver.winf, solver.extras_list)
    wvec = fns.packer.pack_w(solver.w_list)
    cfl = info.steps[-1].cfl
    axes, kappa = newton._pc_params(opts)
    kw = newton._pc_choice(opts, "ANK")
    pc = fns.build_pc(wvec, cfl, axes=axes, kappa=kappa, **kw)
    v = fns.res_flat(wvec)
    v = v / torch.linalg.norm(v)
    build_ms = time_ms(lambda: fns.build_pc(wvec, cfl, axes=axes,
                                            kappa=kappa, **kw),
                       reps=3, warmup=1)
    apply_ms = time_ms(lambda: newton.pc_apply_vec(pc, fns.packer, v),
                       reps=5, warmup=1)
    print(f"  AMG PC ({kw['amg_levels']} levels: "
          f"{' / '.join('x'.join(map(str, o.D.shape[:3])) for o in pc[0].ops)}"
          f"): build {build_ms:.4f} ms (median of 3), apply {apply_ms:.4f} "
          f"ms (median of 5); [14]'s line PC: build {scalar_pc_ms[0]:.4f} "
          f"ms, apply {scalar_pc_ms[1]:.4f} ms")
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"  peak device memory {peak:.3f} GiB")
    del pc, fns

    for k, val in dict(adjointGlobalPreconditioner="multigrid",
                       adjointSubspaceSize=AMG_ADJ_ITERS,
                       adjointMaxIter=AMG_ADJ_ITERS).items():
        solver.setOption(k, val)
    zero_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sens = solver.evalFunctionsSens(ap, {}, ["cl"])[f"{ap.name}_cl"]
    torch.cuda.synchronize()
    k1_adj, k2_adj = launches()
    ainfo = solver.adjoint_info
    rel_res = ainfo.res_norm / ainfo.b_norm
    print(f"  evalFunctionsSens(cl), transposed multigrid PC: "
          f"{time.perf_counter() - t0:.3f} s; {ainfo.iters} GMRES "
          f"iterations to rel {rel_res:.3e}; dcl/dalpha "
          f"{sens['alpha']!r}; K2 launches {k2_adj} (expected 2), K1 "
          f"{k1_adj}")
    assert k2_adj == 2 and k1_adj == 0, (k2_adj, k1_adj)
    assert ainfo.iters == AMG_ADJ_ITERS and np.isfinite(rel_res)
    assert np.isfinite(sens["alpha"]) and np.all(np.isfinite(sens["xv"]))
    return k2, k2_adj


def unsteady_evals(scheme, n_steps):
    """Residual evaluations of n_steps physical steps: BDF's 50 inner RK
    iterations of five stages, or RK4's four stages."""
    return n_steps * (50 * RK_STAGES if scheme == "BDF" else 4)


def unsteady_path():
    """[24]: 2 BDF2 steps, 2 explicit RK4 steps and a 3-instance time
    spectral solve (25 cycles) of the main path's Euler wing through
    ADFLOW, K2 exactly on every residual evaluation; the stability
    derivatives of the pitching instances. Returns the K2 launches."""
    from adflow_torch.api.solver import ADFLOW
    from adflow_torch.core.refstate import AeroProblem
    from adflow_torch.meshgen.analytic import wing_omesh

    mesh = wing_omesh(ni=FULL_DIMS[0], nj=FULL_DIMS[1], nk=FULL_DIMS[2])
    total = 0
    for scheme in ("BDF", "explicit RK"):
        solver = ADFLOW(options=dict(
            euler_options(1), equationMode="unsteady",
            timeIntegrationScheme=scheme, deltaT=UNSTEADY_DT[scheme]),
            mesh=mesh)
        ap = AeroProblem(**EULER)
        solver.setAeroProblem(ap)
        w0 = solver.getStates()
        torch.cuda.synchronize()
        zero_launches()
        t1 = time.perf_counter()
        solver(ap, nTimeSteps=UNSTEADY_STEPS)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        k1, k2 = launches()
        ui = solver.unsteady_info
        moved = float((solver.getStates() - w0).abs().max())
        expected = unsteady_evals(scheme, UNSTEADY_STEPS)
        print(f"  {scheme}, dt {UNSTEADY_DT[scheme]:g}: {ui.n_steps} steps "
              f"to t={ui.times[-1]:.4g} in {t2 - t1:.3f} s: "
              f"{(t2 - t1) / ui.n_steps * 1e3:.3f} ms per physical step; "
              f"final inner residuals {ui.inner_res.tolist()}; largest "
              f"state change {moved:.4e}; K2 launches {k2} (expected "
              f"{expected}), K1 {k1}")
        assert ui.n_steps == UNSTEADY_STEPS and not ui.failed
        assert np.all(np.isfinite(ui.inner_res)) and np.isfinite(moved)
        assert bool(torch.isfinite(solver.getStates()).all())
        assert k2 == expected and k1 == 0, (scheme, k2, expected, k1)
        total += k2
        del solver

    solver = ADFLOW(options=dict(euler_options(TS_CYCLES), **TS_OPTS),
                    mesh=mesh)
    ap = AeroProblem(**EULER)
    solver.setAeroProblem(ap)
    torch.cuda.synchronize()
    zero_launches()
    t1 = time.perf_counter()
    solver(ap, alphaAmplitude=1.0)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    k1, k2 = launches()
    info = solver.solve_info
    n_inst = int(solver.options["timeIntervals"])
    names = ["cl0", "clalpha", "clalphadot", "cd0", "cdalpha", "cmzalpha"]
    funcs = solver.evalFunctions(ap, {}, names)
    expected = info.iterations * RK_STAGES * n_inst
    print(f"  time spectral, {n_inst} instances: {info.iterations} cycles "
          f"(nCycles {TS_CYCLES}, one chunk) in {t2 - t1:.3f} s: "
          f"{(t2 - t1) / info.iterations * 1e3:.3f} ms per cycle; R "
          f"{info.total_r0:.6e} -> {info.total_r_final:.6e}")
    print("  stability derivatives: " + ", ".join(
        f"{n} {funcs[f'{ap.name}_{n}']!r}" for n in names))
    print(f"  K2 launches {k2} (expected {expected}: {RK_STAGES} stages x "
          f"{n_inst} instances a cycle), K1 {k1}")
    assert not info.failed and np.all(np.isfinite(info.history))
    assert all(np.isfinite(funcs[f"{ap.name}_{n}"]) for n in names)
    assert k2 == expected and k1 == 0, (k2, expected, k1)
    return total + k2


def small_run(device, mesh_fn, ap_kw, options, w0=None, perturb=True,
              **call_kw):
    """One small case through ADFLOW on ``device`` from the seeded
    perturbed free stream (``w0``, else made here): (solver, (K1, K2),
    w0, the state before the call)."""
    from adflow_torch.api.solver import ADFLOW
    from adflow_torch.core.refstate import AeroProblem

    solver = ADFLOW(options=options, mesh=mesh_fn(), device=device)
    ap = AeroProblem(**ap_kw)
    solver.setAeroProblem(ap)
    if perturb:
        w0 = perturbed_state(solver) if w0 is None else w0
        solver.setStates(w0)
    before = solver.getStates().double().cpu().numpy()
    zero_launches()
    solver(ap, **call_kw)
    return solver, launches(), w0, before


def hist_rel(a, b):
    a, b = np.asarray(a, float), np.asarray(b, float)
    return float(np.abs(a - b).max() / np.abs(b).max())


def small_solvers_parity():
    """[25]: the slice's small cases on the card (f32) against the CPU
    (f64), exact launch counts on the card. Returns (K1, K2, smoothing)
    launches."""
    from adflow_torch.meshgen.analytic import wing_omesh
    from adflow_torch.ops import cuda_irs

    def euler_wing():
        return wing_omesh(ni=16, nj=8, nk=8)

    def rans_wing():
        return wing_omesh(ni=16, nj=8, nk=8, viscous=True)

    def pair(label, mesh_fn, ap_kw, options, perturb=True, **call_kw):
        cpu, _, w0, _ = small_run("cpu", mesh_fn, ap_kw, options,
                                  perturb=perturb, **call_kw)
        card, k, _, before = small_run("cuda:0", mesh_fn, ap_kw, options,
                                       w0, perturb, **call_kw)
        assert card.dtype == torch.float32 and cpu.dtype == torch.float64
        return cpu, card, k, before

    k1_all = k2_all = 0

    # a '2w' multigrid solve of the RANS-SA wing with its start
    opts = dict(solver_options(SMALL_MG_CYCLES), **SMALL_MG_OPTS)
    cpu, card, (k1, k2), _ = pair("mg", rans_wing, M6, opts, perturb=False)
    err = hist_rel(card.solve_info.history, cpu.solve_info.history)
    expected = (fmg_evals(card.fmg_info) + sum(mg_by_level(card.options))
                * card.solve_info.iterations)
    print(f"  '2w' multigrid, RANS-SA wing 16x8x8, {SMALL_MG_CYCLES} cycles "
          f"after the full-multigrid start (coarse solve "
          f"{'failed, free stream kept' if card.fmg_info[0].failed else 'converged'}"
          f" on the card, "
          f"{'failed' if cpu.fmg_info[0].failed else 'converged'} on the "
          f"CPU): history rel err {err:.3e} (tolerance {SMALL_HIST_RTOL:g}); "
          f"K1 {k1} (expected {expected}), K2 {k2}")
    assert np.all(np.isfinite(card.solve_info.history))
    assert err < SMALL_HIST_RTOL and (k1, k2) == (expected, 0), (k1, k2)
    k1_all += k1
    irs_small = cuda_irs.LAUNCHES
    irs_cycles = (3 * sum(mg_by_level(card.options, True))
                  * card.solve_info.iterations)
    print(f"  smoothing launches {irs_small} (the cycles' {irs_cycles}: 3 "
          f"a stage; the rest the start's)")
    assert irs_small >= irs_cycles, (irs_small, irs_cycles)

    # the DADI smoother on the Euler wing
    opts = dict(euler_options(1), smoother="DADI", useANKSolver=False)
    cpu, card, (k1, k2), _ = pair("dadi", euler_wing, EULER, opts)
    err = hist_rel(card.solve_info.history[:, 0],
                   cpu.solve_info.history[:, 0])
    n = card.solve_info.iterations
    print(f"  DADI, Euler wing 16x8x8, {n} iterations: history rel err "
          f"{err:.3e} (tolerance {SMALL_HIST_RTOL:g}); K2 {k2} (expected "
          f"{n}), K1 {k1}")
    assert err < SMALL_HIST_RTOL and (k1, k2) == (0, n), (k1, k2)
    k2_all += k2

    # one ANK step with the multigrid PC
    opts = dict(euler_options(1), **AMG_OPTS)
    cpu, card, (k1, k2), _ = pair("amg", euler_wing, EULER, opts)
    sc, sg = cpu.solve_info.steps[0].stats, card.solve_info.steps[0].stats
    err = hist_rel(sg[[0, 1, 5]], sc[[0, 1, 5]])
    expected = 2 + card.solve_info.steps[0].res_evals
    print(f"  one ANK step with the multigrid PC, Euler wing 16x8x8: "
          f"residual {sg[1]:.6e} vs {sc[1]:.6e}, Krylov iterations "
          f"{int(sg[4])} vs {int(sc[4])}, linres {sg[5]:.4e} vs "
          f"{sc[5]:.4e}; rel err {err:.3e} (tolerance {ANK_SOLVE_RTOL:g}); "
          f"K2 {k2} (expected {expected}), K1 {k1}")
    assert err < ANK_SOLVE_RTOL and (k1, k2) == (0, expected), (k1, k2)
    k2_all += k2

    # the adjoint of cl with the transposed multigrid PC
    amg_adj = dict(ADJ_EULER_OPTS, adjointGlobalPreconditioner="multigrid")
    cpu_s, _, _, _, w0 = small_adjoint("euler", "cpu", ["cl"], **amg_adj)
    card_s, _, k1, k2, _ = small_adjoint("euler", "cuda:0", ["cl"], w0,
                                         **amg_adj)
    print(f"  K2 launches {k2} (expected 2), K1 {k1}")
    assert (k1, k2) == (0, 2), (k1, k2)
    compare_totals("card vs CPU, transposed multigrid PC, cl",
                   cpu_s["m6e_cl"], card_s["m6e_cl"], ("alpha", "mach"),
                   ADJ_EULER_RTOL)
    k2_all += k2

    # a BDF2 and an explicit RK4 march
    for scheme in ("BDF", "explicit RK"):
        opts = dict(euler_options(1), equationMode="unsteady",
                    timeIntegrationScheme=scheme,
                    deltaT=SMALL_UNSTEADY_DT[scheme])
        cpu, card, (k1, k2), before = pair(
            scheme, euler_wing, EULER, opts, nTimeSteps=UNSTEADY_STEPS)
        dc = cpu.getStates().numpy() - before
        dg = card.getStates().double().cpu().numpy() - before
        err = hist_rel(dg, dc)
        expected = unsteady_evals(scheme, UNSTEADY_STEPS)
        print(f"  {scheme}, Euler wing 16x8x8, {UNSTEADY_STEPS} steps: state "
              f"change rel err {err:.3e} (tolerance {SMALL_HIST_RTOL:g}); "
              f"inner residuals card {card.unsteady_info.inner_res.tolist()}"
              f", CPU {cpu.unsteady_info.inner_res.tolist()}; K2 {k2} "
              f"(expected {expected}), K1 {k1}")
        assert np.all(np.isfinite(dg))
        assert err < SMALL_HIST_RTOL and (k1, k2) == (0, expected), (k1, k2)
        k2_all += k2

    # 3-instance time spectral
    opts = dict(euler_options(TS_CYCLES), **TS_OPTS)
    cpu, card, (k1, k2), _ = pair("ts", euler_wing, EULER, opts,
                                  alphaAmplitude=1.0)
    err = hist_rel(card.solve_info.history[:, 0],
                   cpu.solve_info.history[:, 0])
    expected = card.solve_info.iterations * RK_STAGES * 3
    names = ("cl0", "clalpha", "clalphadot")
    fc = cpu.evalFunctions(cpu.curAP, {}, names)
    fg = card.evalFunctions(card.curAP, {}, names)
    print(f"  time spectral, 3 instances, Euler wing 16x8x8, "
          f"{card.solve_info.iterations} cycles: history rel err {err:.3e} "
          f"(tolerance {SMALL_HIST_RTOL:g}); " + ", ".join(
              f"{k[4:]} {fg[k]:.6g} vs {fc[k]:.6g}" for k in fc)
          + f"; K2 {k2} (expected {expected}), K1 {k1}")
    assert err < SMALL_HIST_RTOL and (k1, k2) == (0, expected), (k1, k2)
    assert all(np.isfinite(v) for v in fg.values())
    k2_all += k2
    return k1_all, k2_all, irs_small


# ---------------------------------------------------------------------------
# [26]-[27]: overset meshes and the geometry tail
# ---------------------------------------------------------------------------

def overset_airfoil_mesh(ni, nj, nk, radius, viscous, **background):
    """The NACA 0012 O-mesh with its JMAX face OVERSET (the receiver) in the
    Cartesian background ``cartesian_background(**background)`` generates
    around it, symmetry planes in z."""
    import dataclasses

    from adflow_torch.core.mesh import BCType, Face, MultiBlockMesh
    from adflow_torch.meshgen.analytic import naca0012_omesh
    from adflow_torch.meshgen.cartmesh import cartesian_background

    near = naca0012_omesh(ni=ni, nj=nj, nk=nk, radius=radius,
                          viscous=viscous).blocks[0]
    bcs = [dataclasses.replace(sf, bc=BCType.OVERSET, family="ovs")
           if sf.face is Face.JMAX else sf for sf in near.bcs]
    near = MultiBlockMesh([dataclasses.replace(near, bcs=bcs)], name="near")
    return cartesian_background(near, sym_planes=("zlow", "zhigh"),
                                **background)


def box_in_box_mesh(n_bg=12, n_in=14):
    """The far-field box [0,1]^3 and an inner box [0.25,0.75]^3 with OVERSET
    faces (tests/test_overset.py)."""
    from adflow_torch.core.mesh import (
        BCSubface, BCType, Block, Face, MultiBlockMesh)
    from adflow_torch.meshgen.analytic import cube_mesh

    xs = [np.linspace(0.25, 0.75, n_in + 1)] * 3
    inner = Block(name="inner",
                  x=np.stack(np.meshgrid(*xs, indexing="ij"), axis=-1),
                  bcs=[BCSubface(face=f, bc=BCType.OVERSET, family="ovs")
                       for f in Face])
    return MultiBlockMesh([cube_mesh(n=n_bg).blocks[0], inner],
                          name="boxbox")


def box_cut(bi, centers):
    """The explicit cut: a hole in the background under the inner core."""
    if bi != 0:
        return np.zeros(len(centers), bool)
    return np.max(np.abs(centers - 0.5), axis=1) < 0.1


def two_patch_mesh(overlap=0.2, n1=24, n2=15):
    """Two disconnected boxes whose z-min viscous walls overlap in x by
    ``overlap`` and together cover [0,1]^2 (tests/test_zipper.py)."""
    from adflow_torch.core.mesh import (
        BCSubface, BCType, Block, Face, MultiBlockMesh)

    def box(name, x0, x1, nx):
        x = np.stack(np.meshgrid(np.linspace(x0, x1, nx + 1),
                                 np.linspace(0.0, 1.0, 9),
                                 np.linspace(0.0, 0.5, 5), indexing="ij"),
                     axis=-1)
        bcs = [BCSubface(face=Face(f), bc=BCType.FARFIELD, family="far")
               for f in (0, 1, 2, 3, 5)]
        bcs.append(BCSubface(face=Face(4), bc=BCType.NS_WALL_ADIABATIC,
                             family="wall"))
        return Block(name=name, x=x, bcs=bcs)

    return MultiBlockMesh([box("fine", 0.0, 0.6, n1),
                           box("coarse", 0.6 - overlap, 1.0, n2)],
                          name="twopatch")


def bumped(pts, height):
    """Wall nodes with the upper surface (y > 0, 0 <= x <= 1) raised by a
    smooth bump of ``height`` chords."""
    x = np.clip(pts[:, 0], 0.0, 1.0)
    out = pts.copy()
    out[:, 1] += np.where(pts[:, 1] > 0.0,
                          height * np.sin(np.pi * x) ** 2, 0.0)
    return out


class CallTimes:
    """Wall seconds of each call of ``module.name`` while active (the
    attribute is swapped for a timing wrapper and restored on exit)."""

    def __init__(self, module, name):
        self.module, self.name, self.seconds = module, name, []

    def __enter__(self):
        fn = self.orig = getattr(self.module, self.name)

        def timed(*a, **k):
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **k)
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            self.seconds.append(time.perf_counter() - t0)
            return out

        setattr(self.module, self.name, timed)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.orig)


def _table_on_cpu(table):
    """A device overset table's groups on the CPU in f64."""
    import dataclasses

    return dataclasses.replace(table, groups=tuple(dataclasses.replace(
        g, dst_flat=g.dst_flat.cpu(), src_flat=g.src_flat.cpu(),
        weights=g.weights.double().cpu()) for g in table.groups))


def _topology_on_cpu(topo):
    import dataclasses

    return dataclasses.replace(
        topo, overset=_table_on_cpu(topo.overset),
        blocks=tuple(dataclasses.replace(
            bs, por=tuple(p.double().cpu() for p in bs.por),
            iblank=None if bs.iblank is None else bs.iblank.double().cpu())
            for bs in topo.blocks))


def check_overset_fill(solver):
    """The card's ``fill_halos`` against the same fill in f64 on the CPU,
    from the same interior state and geometry (the card's f32 metrics and
    table weights, widened), at every overset receiver; per channel, of
    the channel's largest entry. Returns the largest."""
    from adflow_torch.physics.residual import fill_halos

    wf = [w.double().cpu() for w in solver._filled_w()]
    m64 = [type(m)(*(None if t is None else t.double().cpu() for t in m))
           for m in solver.metrics_list]
    want = fill_halos([w.double().cpu() for w in solver.w_list], m64,
                      _topology_on_cpu(solver.topo), solver.ref,
                      solver.winf.double().cpu())
    worst, n = 0.0, 0
    for g in solver.topo.overset.groups:
        idx = g.dst_flat.cpu()
        a = want[g.dst_block].reshape(-1, want[g.dst_block].shape[-1])[idx]
        b = wf[g.dst_block].reshape(-1, wf[g.dst_block].shape[-1])[idx]
        scale = want[g.dst_block].abs().amax(dim=(0, 1, 2))
        worst = max(worst, float(((a - b).abs().amax(dim=0)
                                  / scale).max()))
        n += len(idx)
    print(f"  overset fill, card (f32) vs CPU (f64) at {n} receivers: "
          f"{worst:.3e} of the channel's largest entry (tolerance "
          f"{BC_RTOL:g})")
    assert worst < BC_RTOL, worst
    return worst


def check_warp(solver, x_before, pts0, new_pts):
    """The card's warped f32 nodes against an f64 warp on the CPU of
    WARP_SAMPLE seeded nodes a block, from the same f32 start coordinates
    and surface: the largest error beyond half an f32 ulp of the coordinate,
    of the displacement scale."""
    from adflow_torch.geom.warp import warp_mesh

    disp = new_pts - pts0
    scale = float(np.abs(disp).max())
    rng = np.random.default_rng(0)
    worst, raw = 0.0, 0.0
    for x0, x1 in zip(x_before, solver.x_list):
        flat0 = x0.reshape(-1, 3).double().cpu()
        pick = torch.as_tensor(rng.choice(flat0.shape[0], min(
            WARP_SAMPLE, flat0.shape[0]), replace=False))
        want = warp_mesh(solver.mesh, [flat0[pick]], pts0, disp)[0]
        got = x1.reshape(-1, 3)[pick.to(x1.device)].double().cpu()
        err = (got - want).abs()
        half_ulp = 2.0 ** -24 * want.abs()
        raw = max(raw, float(err.max()) / scale)
        worst = max(worst, float((err - half_ulp).clamp(min=0).max())
                    / scale)
    print(f"  warp, card (f32) vs CPU (f64) on {WARP_SAMPLE} nodes a block: "
          f"{raw:.3e} of the displacement scale {scale:.3e}, {worst:.3e} "
          f"beyond half an f32 ulp of the coordinate (tolerance "
          f"{WARP_RTOL:g})")
    assert worst < WARP_RTOL, worst
    return worst


def check_quick_walldist(solver):
    """The quick wall-distance update against a full search on the card,
    at the warped coordinates: the quick distance projects onto each cell's
    stored quad, so it is never below the nearest one's. Returns the
    largest relative excess and the share of cells where it exceeds 1e-6."""
    from adflow_torch.geom.walldist import compute_wall_distances

    mesh = solver._warped_mesh()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    full = compute_wall_distances(mesh, solver.x_list, cutoff=float(
        solver.options["wallDistCutoff"]))
    torch.cuda.synchronize()
    t_full = time.perf_counter() - t0
    worst, below, moved, n = 0.0, 0.0, 0, 0
    for ex, d in zip(solver.extras_list, full):
        q = ex["walldist"][1:-1, 1:-1, 1:-1].double()
        f = d[1:-1, 1:-1, 1:-1].double()
        worst = max(worst, float(((q - f) / f).max()))
        below = min(below, float((q - f).min()))
        moved += int((q - f > 1e-6 * f).sum())
        n += q.numel()
    print(f"  quick wall distance vs a full search on the card ({t_full:.3f} "
          f"s): largest relative excess {worst:.3e}, {moved} of {n} cells "
          f"above 1e-6 (a nearer quad after the warp); lowest difference "
          f"{below:.3e} chords (tolerance -{WALLDIST_ATOL:g}: the quick "
          f"distance is never below the full one beyond f32 rounding)")
    assert np.isfinite(worst) and below > -WALLDIST_ATOL, below
    return worst, moved / n


def overset_path():
    """[26]: the overset RANS-SA path at full width through ADFLOW; returns
    the K1 launches of its solve and adjoint."""
    from adflow_torch.api.solver import ADFLOW
    from adflow_torch.core.refstate import AeroProblem
    from adflow_torch.geom import walldist, warp
    from adflow_torch.ops import cuda_rans
    from adflow_torch.overset import apply_overset
    from adflow_torch.physics import residual
    from adflow_torch.physics.residual import fill_halos

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    mesh = overset_airfoil_mesh(**OVS_NEAR, **OVS_BG)
    nb = len(mesh.blocks)
    print(f"  blocks {[b.dims for b in mesh.blocks]}, {mesh.n_cells} cells; "
          f"mesh generation {time.perf_counter() - t0:.3f} s")
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    for b in mesh.blocks:
        print(f"  K1 tile plan at {'x'.join(map(str, b.dims))}: "
              f"{cuda_rans.k1_tile_plan(*b.dims, n_sm=n_sm)}")
    opts = dict(solver_options(1), useANKSolver=True)
    zero_launches()
    with CallTimes(residual, "build_overset") as asm:
        t0 = time.perf_counter()
        solver = ADFLOW(options=opts, mesh=mesh)
        ap = AeroProblem(**OVS_AP)
        solver.setAeroProblem(ap)
        torch.cuda.synchronize()
        t_ctor = time.perf_counter() - t0
    print(f"  construction {t_ctor:.3f} s, of which the overset assembly "
          f"{asm.seconds[0]:.3f} s (host); K1, K2 launches {launches()}")
    assert launches() == (0, 0)
    rep = solver.checkOverset()
    for g in solver.topo.overset.groups:
        print(f"    group {g.dst_block}<-{g.src_block} priority "
              f"{g.priority}: {len(g.dst_flat)} receivers")

    k1_total = 0
    steps = []
    for i in range(OVS_STEPS[0]):
        zero_launches()
        t0 = time.perf_counter()
        if i == OVS_STEPS[0] - 1:
            profile_device(lambda: solver(ap), "1 ANK step (overset RANS-SA)",
                           "rans_residual_kernel", host_ops=False)
        else:
            solver(ap)
        torch.cuda.synchronize()
        k1, k2 = launches()
        info = solver.solve_info
        expected = nb * (2 + sum(r.res_evals for r in info.steps))
        print_steps(info, "evaluations")
        print(f"  call {i + 1}: {time.perf_counter() - t0:.3f} s; K1 "
              f"launches {k1} (expected {expected}: {nb} blocks x (2 for "
              f"the driver's norms + the step's evaluations)), K2 {k2}")
        assert np.all(np.isfinite(info.history)) and len(info.steps) == 1
        assert (k1, k2) == (expected, 0), (k1, k2, expected)
        k1_total += k1
        steps.append(info.steps[0].seconds)

    zero_launches()
    funcs = solver.evalFunctions(ap, {})
    print(f"  cl {funcs['ovs_cl']!r}, cd {funcs['ovs_cd']!r}; K1, K2 "
          f"launches {launches()}")
    assert np.isfinite(funcs["ovs_cl"]) and np.isfinite(funcs["ovs_cd"])

    tensors, consts = main_path_operands(solver, block=1)
    _, _, flux_rel = compare_post_solve(tensors, consts)
    assert flux_rel < FLUX_RTOL, flux_rel
    del tensors
    check_overset_fill(solver)
    w = solver.w_list
    fill_ms = time_ms(lambda: fill_halos(w, solver.metrics_list, solver.topo,
                                         solver.ref, solver.winf), reps=10)
    wf = solver._filled_w()
    ovs_ms = time_ms(lambda: apply_overset(wf, solver.topo.overset),
                     reps=10)
    print(f"  fill_halos {fill_ms:.3f} ms, of which the overset "
          f"interpolation alone {ovs_ms:.3f} ms ({ovs_ms / fill_ms:.3f}; "
          f"CUDA events, median of 10)")
    del wf

    pts0 = solver.getSurfaceCoordinates()
    new_pts = bumped(pts0, OVS_BUMP)
    x_before = [x.clone() for x in solver.x_list]
    with CallTimes(warp, "warp_mesh") as t_warp, \
            CallTimes(residual, "build_overset") as t_asm, \
            CallTimes(walldist, "update_wall_distances") as t_wd:
        solver.setSurfaceCoordinates(new_pts)
        t0 = time.perf_counter()
        solver.updateGeometryInfo()
        torch.cuda.synchronize()
        t_geo = time.perf_counter() - t0
    print(f"  updateGeometryInfo {t_geo:.3f} s: the warp "
          f"{t_warp.seconds[0]:.3f} s, the re-assembly {t_asm.seconds[0]:.3f}"
          f" s (host), the quick wall distance {t_wd.seconds[0]:.3f} s; "
          f"peak device memory so far "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.3f} GiB")
    check_warp(solver, x_before, pts0, new_pts)
    del x_before
    check_quick_walldist(solver)
    t0 = time.perf_counter()
    quality = solver.checkMeshQuality()
    print(f"  checkMeshQuality {time.perf_counter() - t0:.3f} s: ok "
          f"{quality['ok']}, min volume {quality['min_volume']:.3e}, "
          f"max skewness {quality['max_skewness']:.3f}, max aspect ratio "
          f"{quality['max_aspect_ratio']:.3e}")
    assert quality["ok"]
    rep2 = solver.checkOverset()
    assert rep2["hole"] > 0 and rep2["fringe"] > 0

    for _ in range(OVS_STEPS[1]):
        zero_launches()
        t0 = time.perf_counter()
        solver(ap)
        torch.cuda.synchronize()
        k1, k2 = launches()
        info = solver.solve_info
        expected = nb * (2 + sum(r.res_evals for r in info.steps))
        print_steps(info, "evaluations")
        print(f"  after the shape change: {time.perf_counter() - t0:.3f} s; "
              f"K1 launches {k1} (expected {expected}), K2 {k2}")
        assert np.all(np.isfinite(info.history))
        assert (k1, k2) == (expected, 0), (k1, k2, expected)
        k1_total += k1
    funcs = solver.evalFunctions(ap, {})
    print(f"  cl {funcs['ovs_cl']!r}, cd {funcs['ovs_cd']!r}")
    assert np.isfinite(funcs["ovs_cl"]) and np.isfinite(funcs["ovs_cd"])

    solver.setOption("adjointSubspaceSize", OVS_ADJ_ITERS)
    solver.setOption("adjointMaxIter", OVS_ADJ_ITERS)
    zero_launches()
    t0 = time.perf_counter()
    sens = solver.evalFunctionsSens(ap, {}, ["cl"])["ovs_cl"]
    torch.cuda.synchronize()
    t_adj = time.perf_counter() - t0
    k1, k2 = launches()
    info = solver.adjoint_info
    xv = sens["xv"]
    print(f"  evalFunctionsSens(cl), {OVS_ADJ_ITERS} GMRES iterations: "
          f"{t_adj:.3f} s, relative residual {info.res_norm / info.b_norm:.3e};"
          f" d/dalpha {sens['alpha']!r}, d/dmach {sens['mach']!r}, |d/dxv| "
          f"{float(np.linalg.norm(xv))!r}; K1 launches {k1} (expected "
          f"{2 * nb}: one forward for the solve's vjp and one for the vjp in "
          f"x, each block), K2 {k2}")
    assert xv.shape == (sum(x.numel() for x in solver.x_list),)
    assert np.all(np.isfinite(xv)) and np.isfinite(sens["alpha"])
    assert (k1, k2) == (2 * nb, 0), (k1, k2)
    k1_total += k1
    print(f"  ms per ANK step {[round(t * 1e3, 1) for t in steps]}; peak "
          f"device memory {torch.cuda.max_memory_allocated() / 2 ** 30:.3f} "
          f"GiB")
    del solver
    return k1_total


def residual_scale(solver, block, r):
    """Each channel's scale for a residual ``r`` of ``block``: the largest
    mean-flow face flux for the mean-flow rows (one number, as the CPU
    tests take it), and for a turbulence row the larger of its row-scaled
    advective flux and its largest entry in ``r`` (``small_residual``)."""
    from adflow_torch.physics.thermo import pressure

    w = solver._filled_w()[block]
    m = solver.metrics_list[block]
    scale = flux_scale(w, pressure(w), (m.siE, m.sjE, m.skE),
                       turb_scales=solver.cfg.turb_scales).to(r)
    return torch.cat([scale[:5].max().expand(5), torch.maximum(
        scale[5:], r.abs().amax(dim=(0, 1, 2))[5:])])


def small_overset_residual(label, mesh_fn, ap, options, want, cut=None):
    """``residual_list`` of an overset mesh at the seeded perturbed free
    stream on the card (f32) and the CPU (f64): the mean-flow rows of every
    block to the CPU's, every row to the plain f32 version on the CPU on
    the card's own inputs, of the flux scale (as ``small_residual``), and
    the launches ``want``. Returns the card's solver, the CPU's, w0 and the
    launches."""
    from adflow_torch.physics.residual import block_residual

    kw = {} if cut is None else {"cutCallback": cut}
    cpu, w0 = small_state("cpu", mesh_fn(), ap, options, **kw)
    card, _ = small_state("cuda:0", mesh_fn(), ap, options, w0, **kw)
    r64 = cpu.getResidual(cpu.curAP)
    zero_launches()
    rg = card.getResidual(card.curAP)
    torch.cuda.synchronize()
    got = launches()
    wf = card._filled_w()
    worst64 = worst32 = 0.0
    for i, bs in enumerate(card.topo.blocks):
        args = _on_cpu((wf[i], card.metrics_list[i], card.cfg, card.ref,
                        card.extras_list[i] if card.extras_list else None,
                        bs.por, bs.iblank))
        r32 = block_residual(*args[:5], por=args[5]) * args[6]
        scale = residual_scale(cpu, i, r32.double())
        g = rg[i].double().cpu()
        worst64 = max(worst64, float(((g - r64[i]).abs().amax(
            dim=(0, 1, 2)) / scale)[:5].max()))
        worst32 = max(worst32, float(((g - r32.double()).abs().amax(
            dim=(0, 1, 2)) / scale).max()))
    print(f"  {label}: residual of {len(rg)} blocks, mean flow card vs CPU "
          f"f64 {worst64:.2e}, every row card vs plain f32 {worst32:.2e} of "
          f"the flux scale (tolerance {FLUX_RTOL:g}); K1, K2 launches {got} "
          f"(expected {want})")
    assert all(bool(torch.isfinite(r).all()) for r in rg)
    assert worst64 < FLUX_RTOL and worst32 < FLUX_RTOL
    assert got == want, (label, got)
    return card, cpu, w0, got


def small_overset_step(label, card, cpu, w0, kernel):
    """One ANK step of each from w0: the histories within ANK_SOLVE_RTOL
    and the launches exact (``kernel`` 0 for K1, 1 for K2; a launch per
    block an evaluation). Returns the launches."""
    nb = len(card.mesh.blocks)
    for s in (cpu, card):
        s.setOption("nCycles", 1)
        s.setStates(w0)
    cpu(cpu.curAP)
    zero_launches()
    card(card.curAP)
    torch.cuda.synchronize()
    got = launches()
    ic, ig = cpu.solve_info, card.solve_info
    n = nb * (2 + sum(r.res_evals for r in ig.steps))
    want = (n, 0) if kernel == 0 else (0, n)
    h_rel = hist_rel(ig.history[:, 0], ic.history[:, 0])
    print(f"  {label}: 1 ANK step, history card vs CPU {h_rel:.3e} "
          f"(tolerance {ANK_SOLVE_RTOL:g}), Krylov iterations "
          f"{int(ig.steps[0].stats[4])} / {int(ic.steps[0].stats[4])}; "
          f"K1, K2 launches {got} (expected {want})")
    assert np.all(np.isfinite(ig.history)) and h_rel < ANK_SOLVE_RTOL
    assert got == want, (label, got)
    return got


def small_overset_parity():
    """[27]: the small overset and geometry cases, card (f32) against the
    CPU (f64), exact launches. Returns the K1 and K2 launches."""
    from adflow_torch.meshgen.analytic import channel_mesh, wing_omesh
    from adflow_torch.overset.assembly import (
        build_zipper_gaps, overlap_surface_weights)
    from adflow_torch.physics.surface import (
        build_wall_patches, cost_functions, integrate_forces)

    k1 = k2 = 0
    euler = euler_options(1)
    # the box-in-box preserves the free stream exactly, so its free-stream
    # residual (the driver's reference) is round-off: ANK from the start
    card, cpu, w0, got = small_overset_residual(
        "box-in-box Euler 12^3 + 14^3, explicit cut", box_in_box_mesh,
        dict(OVS_SMALL_AP, name="bb"), dict(euler, ANKSwitchTol=1e30),
        (0, 2), cut=box_cut)
    k2 += got[1] + small_overset_step("box-in-box", card, cpu, w0, 1)[1]

    def airfoil(viscous):
        return lambda: overset_airfoil_mesh(
            **OVS_SMALL_AIRFOIL, viscous=viscous, **OVS_SMALL_BG)

    rans = dict(solver_options(1), useANKSolver=True)
    card, cpu, w0, got = small_overset_residual(
        "airfoil 40x10 in its background, RANS-SA", airfoil(True),
        OVS_SMALL_AP, rans, (2, 0))
    k1 += got[0] + small_overset_step("airfoil RANS", card, cpu, w0, 0)[0]

    # the zipper: the two-patch mesh's forces with the overlap weights and
    # the gap triangles, laminar, at the seeded perturbed free stream
    lam = dict(euler, equationType="laminar NS")
    worst = 0.0
    res = {}
    for dev in ("cpu", "cuda:0"):
        s, w0 = small_state(dev, two_patch_mesh(), dict(
            OVS_SMALL_AP, name="zp", alpha=0.0), lam,
            None if dev == "cpu" else w0)
        patches = build_wall_patches(s.mesh)
        weights = overlap_surface_weights(s.mesh, patches)
        gaps = build_zipper_gaps(s.mesh, patches, weights)
        f = integrate_forces(s._filled_w(), s.x_list, s.metrics_list,
                             patches, s.ref, s.cfg, patch_weights=weights,
                             zipper=gaps)
        res[dev] = {k: v.double().cpu() for k, v in f.items()}
    # of the force scale p_inf times the wall's area (1; the moment arms
    # are at most 1): at the perturbed free stream the net forces are sums
    # of cancelling noise
    scale = float(s.ref.p_inf)
    for k in res["cpu"]:
        a, b = res["cpu"][k], res["cuda:0"][k]
        worst = max(worst, float((a - b).abs().max()) / scale)
    print(f"  two-patch zipper mesh ({gaps.n_tris} gap triangles): forces, "
          f"moments and centre-of-force sums card vs CPU {worst:.3e} of "
          f"p_inf times the wall's area (tolerance {FLOW_RTOL:g})")
    assert worst < FLOW_RTOL

    # a user surface on the channel: the plane x = 1.5 across it
    ny, nz = 6, 2
    yy, zz = np.meshgrid(np.linspace(0.05, 0.95, ny + 1),
                         np.linspace(0.02, 0.18, nz + 1), indexing="ij")
    pts = np.stack([np.full(yy.shape, 1.5), yy, zz], -1).reshape(-1, 3)
    base = (np.arange(ny)[:, None] * (nz + 1) + np.arange(nz)).reshape(-1)
    conn = np.stack([base, base + nz + 1, base + nz + 2, base + 1], axis=1)
    names = [f"plane_{f}" for f in SURF_FUNCS]
    vals = {}
    for dev in ("cpu", "cuda:0"):
        s, w0 = small_state(dev, channel_mesh(*CHANNEL_DIMS), dict(
            name="ch", mach=0.3, evalFuncs=names), euler,
            None if dev == "cpu" else w0)
        s.addIntegrationSurface((pts, conn), "plane")
        vals[dev] = s.evalFunctions(s.curAP, {})
    worst = max(abs(vals["cuda:0"][k] - vals["cpu"][k]) / abs(vals["cpu"][k])
                for k in vals["cpu"])
    print(f"  user surface on the channel, its six functions card vs CPU "
          f"{worst:.3e} (tolerance {FLOW_RTOL:g}): "
          f"{ {k[3:]: round(v, 6) for k, v in vals['cuda:0'].items()} }")
    assert worst < FLOW_RTOL

    # cperror2 with setTargetCp on the 16x8x8 Euler wing, and its adjoint
    sens = {}
    for dev in ("cpu", "cuda:0"):
        s, w0 = small_state(dev, wing_omesh(*ADJ_DIMS), dict(
            EULER, evalFuncs=["cperror2"]), dict(euler, **OVS_ADJ_OPTS),
            None if dev == "cpu" else w0)
        tgt = np.concatenate([
            np.full(int(np.prod([p.face_sl[a].stop - p.face_sl[a].start
                                 for a in range(3) if a != p.axis])), -0.1)
            for p in s.wall_patches])
        s.setTargetCp(tgt)
        f = s.evalFunctions(s.curAP, {})["m6e_cperror2"]
        zero_launches()
        sens[dev] = (f, s.evalFunctionsSens(s.curAP, {}, ["cperror2"])
                     ["m6e_cperror2"], launches())
    (fc, tc, _), (fg, tg, lg) = sens["cpu"], sens["cuda:0"]
    print(f"  cperror2 on the wing 16x8x8: {fg!r} vs {fc!r} (CPU), rel "
          f"{abs(fg - fc) / abs(fc):.3e}; K1, K2 launches of its adjoint "
          f"{lg} (expected (0, 2))")
    assert abs(fg - fc) < FLOW_RTOL * abs(fc) and lg == (0, 2)
    compare_totals("card vs CPU, cperror2", tc, tg, ("alpha", "mach"),
                   ADJ_EULER_RTOL)
    k2 += lg[1]

    # evalFunctionsSens(cl) on the overset airfoil (Euler), with xv
    sens = {}
    for dev in ("cpu", "cuda:0"):
        s, w0 = small_state(dev, airfoil(False)(), OVS_SMALL_AP,
                            dict(euler, **OVS_ADJ_OPTS),
                            None if dev == "cpu" else w0)
        zero_launches()
        sens[dev] = (s.evalFunctionsSens(s.curAP, {}, ["cl"])["ov_cl"],
                     launches(), s.adjoint_info)
    (tc, _, ic), (tg, lg, ig) = sens["cpu"], sens["cuda:0"]
    print(f"  overset airfoil adjoint of cl: GMRES iterations card "
          f"{ig.iters} / CPU {ic.iters}; K1, K2 launches {lg} (expected "
          f"(0, 4): 2 blocks x 2)")
    assert lg == (0, 4), lg
    compare_totals("card vs CPU, overset cl", tc, tg, ("alpha", "mach"),
                   ADJ_EULER_RTOL)
    k2 += lg[1]

    # a warp followed by the quick wall-distance update, RANS airfoil
    out = {}
    for dev in ("cpu", "cuda:0"):
        s, w0 = small_state(dev, airfoil(True)(), OVS_SMALL_AP, rans,
                            None if dev == "cpu" else w0)
        pts0 = s.getSurfaceCoordinates()
        s.setSurfaceCoordinates(bumped(pts0, 0.02))
        s.updateGeometryInfo()
        out[dev] = ([x.double().cpu() for x in s.x_list],
                    [e["walldist"].double().cpu()[1:-1, 1:-1, 1:-1]
                     for e in s.extras_list],
                    [a.cpu() for a in s._walldist_assoc],
                    s.checkOverset(printReport=False))
    (xc, dc, ac, oc), (xg, dg, ag, og) = out["cpu"], out["cuda:0"]
    # beyond an f32 ulp of the coordinate (the card's start coordinates
    # are rounded to f32 too), of the bump's height
    x_err = max(float(((a - b).abs() - 2.0 ** -23 * a.abs()).clamp(
        min=0).max()) for a, b in zip(xc, xg)) / 0.02
    same = [(a == b).reshape(d.shape) for a, b, d in zip(ac, ag, dc)]
    d_err = max(float((a - b).abs()[m].max())
                for a, b, m in zip(dc, dg, same))
    n_diff = sum(int((~m).sum()) for m in same)
    print(f"  warp + quick wall distance, RANS airfoil: nodes card vs CPU "
          f"{x_err:.3e} of the bump beyond an f32 ulp (tolerance "
          f"{WARP_RTOL:g}); wall distance {d_err:.3e} chords where both "
          f"chose the same quad (tolerance {WALLDIST_ATOL:g}; {n_diff} cells "
          f"chose another); overset after the warp card {og} vs CPU {oc}")
    assert x_err < WARP_RTOL and d_err < WALLDIST_ATOL
    # the re-assembly runs on f32-rounded coordinates on the card's side:
    # a cell at a threshold of the hole cut may fall either way
    assert og["groups"] == oc["groups"] and all(
        abs(og[k] - oc[k]) <= 0.01 * oc["n_cells"]
        for k in ("compute", "fringe", "hole", "orphans")), (og, oc)
    return k1, k2


def _timed(times, label, fn):
    """``fn()``, its wall time (synchronised) kept in ``times[label]``."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    times[label] = time.perf_counter() - t0
    return out


def _bc_table(mesh):
    return [[(sf.face, sf.bc, sf.family, sf.rng) for sf in b.bcs]
            + [(c.face, c.donor_block, c.transform, c.offset)
               for c in b.conns] for b in mesh.blocks]


def design_point_files(solver):
    """[28]: the design point's files on the main path's solved wing,
    ``solver`` reused with no new solve: the mesh through ``.npz`` and
    CGNS and ``gridFile``, ``writeSolution`` (volume CGNS, surface and
    lift files; one K2 launch a block for the residual menu), a restart
    bitwise equal to the written state, the nodal forces against
    ``evalFunctions``, the force and slice files and a family function.
    Returns the K2 launches of the write."""
    import importlib.util
    import os
    import shutil

    from adflow_torch.api.solver import ADFLOW
    from adflow_torch.core.refstate import AeroProblem
    from adflow_torch.io.cgns import read_cgns
    from adflow_torch.io.meshio import write_npz

    if importlib.util.find_spec("h5py") is None:
        print("  h5py is absent: the CGNS files are written and read in "
              "the ADF flavour (adflow_torch/io/adf.py), which needs no "
              "h5py")
    else:
        print("  h5py is present: the CGNS files are written in the HDF5 "
              "flavour")
    shutil.rmtree(DESIGN_DIR, ignore_errors=True)
    os.makedirs(DESIGN_DIR)
    torch.cuda.reset_peak_memory_stats()
    times = {}
    opts = euler_options(ANK_STEPS)
    mesh = solver.mesh
    path = os.path.join(DESIGN_DIR, "wing.npz")
    _timed(times, "write_npz", lambda: write_npz(mesh, path))
    from_npz = _timed(times, "ADFLOW(gridFile=.npz)",
                      lambda: ADFLOW(options=dict(opts, gridFile=path)))
    assert np.array_equal(from_npz.mesh.blocks[0].x, mesh.blocks[0].x)
    assert torch.equal(from_npz.x_list[0], solver.x_list[0])
    assert _bc_table(from_npz.mesh) == _bc_table(mesh)
    del from_npz
    path = os.path.join(DESIGN_DIR, "wing_mesh.cgns")
    _timed(times, "writeMeshFile", lambda: solver.writeMeshFile(path))
    from_cgns = _timed(times, "read_cgns", lambda: read_cgns(path))
    assert np.array_equal(from_cgns.blocks[0].x, mesh.blocks[0].x)
    assert _bc_table(from_cgns) == _bc_table(mesh)

    solver.addLiftDistribution(DESIGN_LIFT_SEGMENTS, "z")
    zero_launches()
    _timed(times, "writeSolution", lambda: solver.writeSolution(
        outputDir=DESIGN_DIR, baseName="m6e"))
    k1, k2 = launches()
    base = os.path.join(DESIGN_DIR, "m6e_000")
    sizes = {ext: os.path.getsize(base + ext)
             for ext in ("_vol.cgns", "_surf.dat", "_lift.dat")}
    print(f"  writeSolution: {sizes} bytes; K2 launches {k2} (expected "
          f"{len(mesh.blocks)}: one residual a block for 'resrho'), K1 {k1}")
    assert k2 == len(mesh.blocks) and k1 == 0, (k2, k1)

    def restart():
        s = ADFLOW(options=dict(opts, restartFile=base + "_vol.cgns"),
                   mesh=mesh)
        s.setAeroProblem(AeroProblem(**EULER))
        return s

    restarted = _timed(times, "restart (ADFLOW + setAeroProblem)", restart)
    same = torch.equal(restarted.getStates(), solver.getStates())
    print(f"  restart from the volume file: state bitwise equal to the "
          f"written one: {same} ({restarted.dtype})")
    assert same and restarted.dtype == torch.float32
    del restarted

    ap = solver.curAP
    forces = _timed(times, "getForces", solver.getForces)
    funcs = solver.evalFunctions(ap, {}, ["fx", "fy", "fz", "cl"])
    want = np.array([funcs[f"{ap.name}_{k}"] for k in ("fx", "fy", "fz")])
    err = float(np.abs(forces.sum(axis=0) - want).max()
                / np.abs(want).max())
    print(f"  getForces: {forces.shape[0]} nodes, column sums "
          f"{forces.sum(axis=0).tolist()} against fx, fy, fz "
          f"{want.tolist()}: {err:.3e} of the largest (tolerance "
          f"{FORCE_RTOL:g})")
    assert err < FORCE_RTOL
    _timed(times, "writeForceFile", lambda: solver.writeForceFile(
        os.path.join(DESIGN_DIR, "forces.txt")))
    solver.addSlices("z", list(DESIGN_SLICES_Z))
    path = os.path.join(DESIGN_DIR, "slices.dat")
    _timed(times, "writeSlicesFile", lambda: solver.writeSlicesFile(path))
    zones = sum(line.startswith("ZONE") for line in open(path))
    name = solver.addFunction("cl", "wall")
    fam = solver.evalFunctions(ap, {}, ["cl", name])
    print(f"  slices: {zones} zones; addFunction('cl', 'wall'): "
          f"{fam[f'{ap.name}_{name}']!r} against cl "
          f"{fam[f'{ap.name}_cl']!r}")
    assert zones == len(DESIGN_SLICES_Z)
    assert fam[f"{ap.name}_{name}"] == fam[f"{ap.name}_cl"]
    for label, sec in times.items():
        print(f"  {label}: {sec:.3f} s")
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"  peak device memory {peak:.3f} GiB")
    shutil.rmtree(DESIGN_DIR)
    return k2


def cl_solve(device):
    """[29]'s ``solveCL`` of the 16x8x8 Euler wing on ``device``: (alpha,
    [(alpha, cl, steps, K2 launches expected, R/R0) a solve], seconds)."""
    from adflow_torch.api.solver import ADFLOW
    from adflow_torch.core.refstate import AeroProblem
    from adflow_torch.meshgen.analytic import wing_omesh

    solver = ADFLOW(options=dict(euler_options(CL_OPTS["nCycles"]),
                                 **CL_OPTS),
                    mesh=wing_omesh(ni=16, nj=8, nk=8), device=device)
    ap = AeroProblem(**dict(EULER, alpha=CL_ALPHA0, evalFuncs=["cl"]))
    log = []
    evaluate = solver.evalFunctions

    def record(ap_, funcs, evalFuncs=None, ignoreMissing=True):
        out = evaluate(ap_, funcs, evalFuncs, ignoreMissing)
        info = solver.solve_info
        log.append((ap_.alpha, out[f"{ap_.name}_cl"], len(info.steps),
                    2 + sum(r.res_evals for r in info.steps),
                    info.total_r_final / info.total_r0))
        return out

    solver.evalFunctions = record
    t0 = time.perf_counter()
    alpha = solver.solveCL(ap, CL_STAR, alpha0=CL_ALPHA0, delta=CL_DELTA,
                           tol=CL_TOL, maxIter=CL_MAX_ITER)
    return alpha, log, time.perf_counter() - t0


def cl_reference():
    """[29]'s float64 ``solveCL`` on the CPU, in a process of its own."""
    torch.set_num_threads(CL_REF_THREADS)
    return cl_solve("cpu")


def outer_solves(solver, cl_ref):
    """[29]: ``solveCL`` of the small wing on the card against the CPU's
    (``cl_ref``, the future of ``cl_reference``), ``solveErrorEstimate`` of
    cl on the main path's wing (``solver``), a SIGUSR2 stop, the
    ``jaxProfileDir`` trace, the MPhys adapter's dot-product identity and
    the Tecplot volume and isosurface writers against the CPU's. Returns
    the K2 launches: (error estimate, solveCL, the small cases)."""
    import glob
    import os
    import signal

    from adflow_torch.api import solver as api
    from adflow_torch.core.refstate import AeroProblem
    from adflow_torch.integrations.mphys import ImplicitCFDAdapter
    from adflow_torch.meshgen.analytic import wing_omesh

    os.makedirs(DESIGN_DIR, exist_ok=True)
    ap = solver.curAP
    zero_launches()
    t0 = time.perf_counter()
    est = solver.solveErrorEstimate(ap, "cl")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    k1, k2_err = launches()
    print(f"  solveErrorEstimate(cl) on the {'x'.join(map(str, FULL_DIMS))} "
          f"wing: {est!r} in {wall:.3f} s ({solver.adjoint_info.iters} GMRES "
          f"iterations); K2 launches {k2_err} (expected 2: the vjp in w of "
          f"the adjoint solve and the residual), K1 {k1}")
    assert np.isfinite(est) and k2_err == 2 and k1 == 0, (est, k2_err, k1)

    zero_launches()
    alpha, log, wall = cl_solve("cuda:0")
    k1, k2_cl = launches()
    ref_alpha, ref_log, ref_wall = cl_ref.result()
    expected = sum(r[3] for r in log)
    print(f"  solveCL to cl {CL_STAR:g} from alpha {CL_ALPHA0:g}, "
          f"{CL_OPTS}: card {alpha!r} in {wall:.3f} s, CPU (float64, "
          f"{CL_REF_THREADS} threads) {ref_alpha!r} in {ref_wall:.3f} s")
    for (a, c, n, _, r), (ra, rc, rn, _, rr) in zip(log, ref_log):
        print(f"    alpha {a:.9f} / {ra:.9f}: cl {c:.7f} / {rc:.7f} "
              f"(diff {abs(c - rc):.2e}), {n} / {rn} steps, R/R0 "
              f"{r:.2e} / {rr:.2e}")
    print(f"  K2 launches {k2_cl} (expected {expected}: 2 + the steps' "
          f"evaluations a solve), K1 {k1}")
    assert len(log) == len(ref_log)
    assert abs(alpha - ref_alpha) < CL_ALPHA_ATOL, (alpha, ref_alpha)
    assert all(abs(c - rc) < CL_ATOL for (_, c, *_), (_, rc, *_)
               in zip(log, ref_log))
    assert abs(log[-1][1] - CL_STAR) < CL_TOL
    assert k2_cl == expected and k1 == 0, (k2_cl, expected, k1)

    zero_launches()
    sent = []
    row = api._IterMonitor.__call__

    def monitor_row(self, it, *args, **kwargs):
        row(self, it, *args, **kwargs)
        if not sent:
            sent.append(it)
            os.kill(os.getpid(), signal.SIGUSR2)

    before = signal.getsignal(signal.SIGUSR2)
    api._IterMonitor.__call__ = monitor_row
    try:
        s = api.ADFLOW(options=dict(
            euler_options(50), L2Convergence=1e-14, printIterations=True,
            outputDirectory=DESIGN_DIR), mesh=wing_omesh(ni=16, nj=8, nk=8))
        s(AeroProblem(**dict(EULER, name="sig")))
    finally:
        api._IterMonitor.__call__ = row
    written = sorted(os.path.basename(f)
                     for f in glob.glob(os.path.join(DESIGN_DIR, "*_sig*")))
    print(f"  SIGUSR2 sent by the monitor after step {sent[0]}: the solve "
          f"stopped after {s.solve_info.iterations} steps and wrote "
          f"{written}")
    assert s.solve_info.iterations == sent[0] == 1
    assert written == ["sig_sig_000_surf.dat", "sig_sig_000_vol.cgns"]
    assert signal.getsignal(signal.SIGUSR2) is before

    trace_dir = os.path.join(DESIGN_DIR, "trace")
    s = api.ADFLOW(options=dict(euler_options(1), jaxProfileDir=trace_dir),
                   mesh=wing_omesh(ni=16, nj=8, nk=8))
    s(AeroProblem(**EULER))
    traces = glob.glob(os.path.join(trace_dir, "*.pt.trace.json"))
    print(f"  jaxProfileDir: {len(traces)} trace of "
          f"{[os.path.getsize(t) for t in traces]} bytes")
    assert len(traces) == 1 and os.path.getsize(traces[0]) > 0

    adapter = ImplicitCFDAdapter(s, s.curAP)
    w0 = perturbed_state(s)
    adapter.set_states(w0)
    rng = np.random.default_rng(3)
    nx = adapter.get_coords().size
    vw, vx, u = (rng.standard_normal(w0.size), rng.standard_normal(nx),
                 rng.standard_normal(w0.size))
    fwd = float(np.dot(adapter.apply_linear_fwd(wDot=vw, xVDot=vx), u))
    gw, gx = adapter.apply_linear_rev(u)
    rev = float(np.dot(gw, vw) + np.dot(gx, vx))
    dot_rel = abs(fwd - rev) / abs(fwd)
    print(f"  MPhys adapter: <J v, u> {fwd!r}, <v, J^T u> {rev!r}, rel "
          f"{dot_rel:.3e} (tolerance {MPHYS_DOT_RTOL:g})")
    assert dot_rel < MPHYS_DOT_RTOL

    zones = {}
    w0 = None
    for device in ("cpu", "cuda:0"):
        s = api.ADFLOW(options=dict(euler_options(1),
                                    volumeVariables=["resrho", "mach"]),
                       mesh=wing_omesh(ni=16, nj=8, nk=8), device=device)
        s.setAeroProblem(AeroProblem(**EULER))
        w0 = perturbed_state(s, amp=ISO_AMP) if w0 is None else w0
        s.setStates(w0)
        tag = device.split(":")[0]
        vol = os.path.join(DESIGN_DIR, f"{tag}_vol.dat")
        iso = os.path.join(DESIGN_DIR, f"{tag}_iso.dat")
        s.writeTecplotVolumeFile(vol)
        s.writeIsoSurfaceFile(iso, ISO_SURFACES)
        zones[tag] = [line.strip() for path in (vol, iso)
                      for line in open(path) if line.startswith("ZONE")]
    print(f"  Tecplot volume and isosurface files, card against CPU: zones "
          f"{zones['cuda']}")
    assert zones["cuda"] == zones["cpu"]
    k1, k2_small = launches()
    print(f"  the small cases' K2 launches {k2_small}, K1 {k1}")
    assert k1 == 0
    import shutil
    shutil.rmtree(DESIGN_DIR)
    return k2_err, k2_cl, k2_small


# [30], several devices: the stacked layout at full width under an NCCL
# process group of one rank (the card machine has one card; NCCL refuses
# two ranks on one card, so the several-rank logic is held by the gloo
# tests on the CPU). The main path's wing balanced over 4 gives 4 slots of
# 64x64x64, so every stacked evaluation launches its kernel 4 times.
STACK_SLOTS = 4
STACK_RES_RTOL = FLUX_RTOL   # stacked vs single-block residual, flux scale
STACK_RK_STEPS = 3
STACK_CFL = 5.0
STACK_SMALL_DIMS = (16, 8, 8)


def nccl_group():
    """An NCCL process group of one rank on cuda:0, at a free localhost
    port; its failure fails the run."""
    import socket

    import torch.distributed as dist
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                            rank=0, world_size=1,
                            device_id=torch.device("cuda:0"))
    assert dist.get_backend() == "nccl" and dist.get_world_size() == 1
    return dist.group.WORLD


def i_offsets(block, mesh2):
    """Each block of ``mesh2`` (``block`` cut along i) as its first i
    index in ``block``."""
    out = []
    for b in mesh2.blocks:
        assert b.dims[1:] == block.dims[1:], b.dims
        hit = np.nonzero(np.all(block.x[:, 0, 0] == b.x[0, 0, 0], axis=-1))
        out.append(int(hit[0][0]))
    return out


def stacked_solver(mesh2, order, options, ap_kw, device, group=None):
    """An ADFLOW on the balanced mesh (its cfg, reference state, metrics
    and wall distances) and the stacked problem, metrics, wall distances
    and free-stream stack of ``device``."""
    from adflow_torch.api.solver import ADFLOW
    from adflow_torch.core.refstate import AeroProblem
    from adflow_torch.dist import stacked

    s = ADFLOW(options=options, mesh=mesh2, device=device)
    s.setAeroProblem(AeroProblem(**ap_kw))
    prob = stacked.build_stacked_problem(mesh2, order, group=group,
                                         dtype=s.dtype, device=s.device)
    sm = stacked.stack_metrics(mesh2, prob, s.dtype,
                               metrics_all=s._metrics_base)
    extras = None
    if s.cfg.rans:
        extras = {"walldist": stacked.stack_walldist(
            mesh2, prob, [e["walldist"] for e in s.extras_list], s.dtype)}
    return s, prob, sm, extras


def counted_ank_step(*args, **kwargs):
    """``stacked_ank_step`` and the residual evaluations it made."""
    from adflow_torch.dist import stacked
    calls = [0]
    plain = stacked.stacked_residual

    def counting(*a, **k):
        calls[0] += 1
        return plain(*a, **k)

    stacked.stacked_residual = counting
    try:
        out = stacked.stacked_ank_step(*args, **kwargs)
    finally:
        stacked.stacked_residual = plain
    return out, calls[0]


def stacked_main_path(solver, group):
    """[30] at full width on [12]'s solved Euler wing: checkPartitioning,
    the balance, the stacked residual against the single-block one, the
    exchange against the CPU's, 1 stacked ANK step; then 3 stacked RK
    steps of the viscous RANS-SA wing. Returns (K1, K2) launches."""
    from adflow_torch.dist import comm, stacked
    from adflow_torch.meshgen.analytic import wing_omesh
    from adflow_torch.physics.residual import residual_list
    from adflow_torch.physics.thermo import pressure

    t0 = time.perf_counter()
    imb, _ = solver.checkPartitioning(STACK_SLOTS)
    mesh2, order = stacked.balance_blocks(solver.mesh, STACK_SLOTS)
    dims = [b.dims for b in mesh2.blocks]
    print(f"  checkPartitioning({STACK_SLOTS}) imbalance {imb!r}; "
          f"balance_blocks: {dims}, order {order} "
          f"({time.perf_counter() - t0:.3f} s)")
    ni, nj, nk = solver.mesh.blocks[0].dims
    assert imb == 0.0 and dims == [(ni // STACK_SLOTS, nj, nk)] * STACK_SLOTS

    # the stacked Euler residual at the solved state against the block's
    s2, prob, sm, _ = stacked_solver(
        mesh2, order, euler_options(1), EULER, "cuda:0", group)
    offs = i_offsets(solver.mesh.blocks[0], mesh2)
    wsol = solver.w_list[0]
    w_list = []
    for b, lo in zip(mesh2.blocks, offs):
        wb = s2.winf.expand(tuple(d + 4 for d in b.dims) + (5,)).clone()
        wb[2:-2, 2:-2, 2:-2] = wsol[2 + lo:2 + lo + b.dims[0], 2:-2, 2:-2]
        w_list.append(wb)
    w = stacked.stack_from_list(prob, w_list, s2.winf, s2.dtype)
    zero_launches()
    r = stacked.stacked_residual(w, sm, prob, s2.cfg, s2.ref, s2.winf)
    torch.cuda.synchronize()
    k1_res, k2_res = launches()
    r1 = residual_list(solver.w_list, solver.metrics_list, solver.topo,
                       solver.cfg, solver.ref, solver.winf)[0]
    wf = solver._filled_w()[0]
    m = solver.metrics_list[0]
    scale = flux_scale(wf, pressure(wf), (m.siE, m.sjE, m.skE))
    err = 0.0
    for b, pos in enumerate(prob.slots):
        orig = prob.order[pos]
        lo, n = offs[orig], mesh2.blocks[orig].dims[0]
        d = (r[b] - r1[lo:lo + n]).abs().amax(dim=(0, 1, 2)) / scale
        err = max(err, float(d.max()))
    print(f"  stacked Euler residual (4 slots) against the single block: "
          f"{err:.3e} of the flux scale (tolerance {STACK_RES_RTOL:g}); "
          f"K2 launches {k2_res}, K1 {k1_res}")
    assert k2_res == STACK_SLOTS and k1_res == 0, (k2_res, k1_res)
    assert err < STACK_RES_RTOL

    # the exchange on the card against the CPU's, same f32 input
    prob_cpu = stacked.build_stacked_problem(mesh2, order,
                                             dtype=torch.float32)
    ex = comm.exchange(w, prob.plan).cpu()
    ex_cpu = comm.exchange(w.cpu(), prob_cpu.plan)
    n_ghost = len(prob.halo.dst_flat)
    print(f"  exchange of {n_ghost} ghost cells: card bitwise equal to CPU "
          f"{torch.equal(ex, ex_cpu)}")
    assert torch.equal(ex, ex_cpu)

    # 1 stacked ANK step from the solved state, timed
    zero_launches()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    (w_new, rn, rnew, lin), evals = counted_ank_step(
        w, sm, prob, s2.cfg, s2.ref, s2.winf, STACK_CFL)
    torch.cuda.synchronize()
    t_ank = time.perf_counter() - t1
    k1_ank, k2_ank = launches()
    print(f"  1 stacked ANK step (CFL {STACK_CFL:g}): res {rn:.6e} -> "
          f"{rnew:.6e}, linres {lin:.3e}, {t_ank * 1e3:.3f} ms; residual "
          f"evaluations {evals}, K2 launches {k2_ank} (expected "
          f"{STACK_SLOTS} x {evals}), K1 {k1_ank}")
    assert k2_ank == STACK_SLOTS * evals and k1_ank == 0
    assert np.isfinite(rnew) and torch.isfinite(w_new).all()
    del s2, w, w_new, r, r1, ex, ex_cpu

    # 3 stacked RK steps of the viscous RANS-SA wing through K1
    mesh_v = wing_omesh(ni=FULL_DIMS[0], nj=FULL_DIMS[1], nk=FULL_DIMS[2],
                        viscous=True)
    mesh_v2, order_v = stacked.balance_blocks(mesh_v, STACK_SLOTS)
    s3, prob_v, sm_v, ex_v = stacked_solver(
        mesh_v2, order_v, solver_options(1), M6, "cuda:0", group)
    step = stacked.make_stacked_rk_step(prob_v, s3.cfg, s3.ref,
                                        cfl=float(s3.options["CFL"]))
    wv = stacked.stack_state(prob_v, s3.winf, s3.dtype)
    zero_launches()
    norms, ms = [], []
    for _ in range(STACK_RK_STEPS):
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        wv, nrm = step(wv, sm_v, s3.winf, ex_v)
        norms.append(nrm.tolist())
        ms.append((time.perf_counter() - t2) * 1e3)
    k1_rk, k2_rk = launches()
    print(f"  {STACK_RK_STEPS} stacked RK steps of the RANS-SA wing "
          f"({STACK_SLOTS} slots of "
          f"{'x'.join(map(str, mesh_v2.blocks[0].dims))}): norms "
          f"{norms}, ms {[round(t, 3) for t in ms]}; K1 launches {k1_rk} "
          f"(expected {STACK_SLOTS} x {RK_STAGES} x {STACK_RK_STEPS}), "
          f"K2 {k2_rk}")
    assert k1_rk == STACK_SLOTS * RK_STAGES * STACK_RK_STEPS and k2_rk == 0
    assert np.all(np.isfinite(norms)) and torch.isfinite(wv).all()
    return k1_rk, k2_res + k2_ank


def small_stacked_parity(group):
    """[30] on the small wing, card (f32) against CPU (f64): one stacked
    ANK step from a seeded perturbation over 4 slots, and the k-split
    residual (one shard: the group has one rank)."""
    from adflow_torch.dist import sharded, stacked
    from adflow_torch.geom.metrics import compute_metrics
    from adflow_torch.meshgen.analytic import wing_omesh
    from adflow_torch.physics.thermo import pressure

    mesh = wing_omesh(*STACK_SMALL_DIMS)
    mesh2, order = stacked.balance_blocks(mesh, STACK_SLOTS)
    runs, w0 = {}, None
    zero_launches()
    for device in ("cpu", "cuda:0"):
        s, prob, sm, _ = stacked_solver(
            mesh2, order, euler_options(1), EULER, device,
            group if device != "cpu" else None)
        w = stacked.stack_state(prob, s.winf, torch.float64)
        if w0 is None:
            rng = np.random.default_rng(0)
            w0 = w.numpy() * (1.0 + 1e-3 * rng.standard_normal(w.shape))
        w = torch.as_tensor(w0, dtype=s.dtype, device=s.device)
        (w_new, rn, rnew, lin), evals = counted_ank_step(
            w, sm, prob, s.cfg, s.ref, s.winf, STACK_CFL)
        runs[device] = ((w_new - w).double().cpu().numpy(),
                        np.array([rn, rnew, lin]), evals)
    k1, k2 = launches()
    (dc, sc, ec), (dg, sg, eg) = runs["cpu"], runs["cuda:0"]
    d_rel = float(np.abs(dg - dc).max() / np.abs(dc).max())
    s_rel = float(np.abs(sg[:2] - sc[:2]).max() / np.abs(sc[:2]).max())
    print(f"  wing {'x'.join(map(str, STACK_SMALL_DIMS))} over "
          f"{STACK_SLOTS} slots, 1 stacked ANK step: card (f32) vs CPU "
          f"(f64) update rel err {d_rel:.3e}, norms rel err {s_rel:.3e} "
          f"(tolerance {ANK_SOLVE_RTOL:g}); evaluations card {eg}, CPU "
          f"{ec}; K2 launches {k2} (expected {STACK_SLOTS} x {eg})")
    assert d_rel < ANK_SOLVE_RTOL and s_rel < ANK_SOLVE_RTOL
    assert k2 == STACK_SLOTS * eg and k1 == 0, (k1, k2)

    # the k-split residual, one shard on each side
    res = {}
    zero_launches()
    for device in ("cpu", "cuda:0"):
        s, _, _, _ = stacked_solver(mesh2, order, euler_options(1), EULER,
                                    device, None)
        g = group if device != "cpu" else None
        prob = sharded.build_sharded_problem(mesh, 1, group=g,
                                             dtype=s.dtype, device=s.device)
        x = torch.as_tensor(mesh.blocks[0].x, dtype=s.dtype, device=s.device)
        met = sharded.shard_of(sharded.split_metrics(compute_metrics(x), 1),
                               0)
        rng = np.random.default_rng(1)
        wb = s.winf.double().cpu().numpy() * (1.0 + 1e-3 * rng.standard_normal(
            tuple(d + 4 for d in mesh.blocks[0].dims) + (5,)))
        wb = torch.as_tensor(wb, dtype=s.dtype, device=s.device)
        r = sharded.sharded_residual(wb, met, prob, s.cfg, s.ref, s.winf)
        wf = sharded.fill_halos_sharded(wb, met, prob, s.ref, s.winf)
        res[device] = (r.double().cpu(), flux_scale(
            wf.double(), pressure(wf.double()),
            (met.siE.double(), met.sjE.double(), met.skE.double())).cpu())
    k1s, k2s = launches()
    (rc, scale), (rg, _) = res["cpu"], res["cuda:0"]
    err = float(((rg - rc).abs().amax(dim=(0, 1, 2)) / scale).max())
    print(f"  k-split residual (1 shard) card vs CPU: {err:.3e} of the flux "
          f"scale (tolerance {STACK_RES_RTOL:g}); K2 launches {k2s}")
    assert err < STACK_RES_RTOL and k2s == 1 and k1s == 0
    return k2 + k2s


def dist_path(solver):
    """[30]; returns the K1 and K2 launches of its paths, by path."""
    import torch.distributed as dist

    group = nccl_group()
    try:
        k1_rk, k2_full = stacked_main_path(solver, group)
        k2_small = small_stacked_parity(group)
    finally:
        dist.destroy_process_group()
    return ({"stacked_rk_rans_wing_4x64x64x64": k1_rk},
            {"stacked_euler_wing_4x64x64x64": k2_full,
             "stacked_small_cases": k2_small})


def solver_slice(phase, scalar_pc_ms):
    """[22]-[25]; returns the K1, K2 and smoothing launches of their main
    paths, by path (K1's multigrid run by level and instantiation)."""
    phase(f"[22] the slice at full width: the full-multigrid start and "
          f"{MG_CYCLES} '3w' cycles of the {'x'.join(map(str, FULL_DIMS))} "
          f"RANS-SA wing, then the DADI smoother")
    k1_mg, irs_mg, k1_dadi = mg_path(RK_SUMMARY)
    phase(f"[23] the AMG preconditioner at full width: {AMG_STEPS} ANK steps "
          f"and the adjoint of cl on the {'x'.join(map(str, FULL_DIMS))} "
          f"Euler wing")
    k2_amg, k2_amg_adj = amg_path(scalar_pc_ms)
    phase(f"[24] unsteady (BDF2, RK4) and time spectral on the "
          f"{'x'.join(map(str, FULL_DIMS))} Euler wing")
    k2_unsteady = unsteady_path()
    phase("[25] small cases, card against CPU: multigrid and its start, "
          "DADI, the AMG ANK step and adjoint, BDF2, RK4, time spectral")
    k1_small, k2_small, irs_small = small_solvers_parity()
    return ({**{f"mg_rans_wing_{k}": n for k, n in k1_mg.items()},
             "dadi_rans_wing_256x64x64": k1_dadi,
             "solvers_small_cases": k1_small},
            {"amg_ank_euler_wing_256x64x64": k2_amg,
             "amg_adjoint_euler_wing_256x64x64": k2_amg_adj,
             "unsteady_ts_euler_wing_256x64x64": k2_unsteady,
             "solvers_small_cases": k2_small},
            {"mg_rans_wing_256x64x64": irs_mg,
             "solvers_small_cases": irs_small})


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
    from adflow_torch.ops import (_nvcc, cuda_bc, cuda_inviscid, cuda_irs,
                                  cuda_rans, mg_timing)

    t_start = time.perf_counter()
    card = card_line()
    name = torch.cuda.get_device_name(0)
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {name}")
    phase = Phases()

    phase("[1] build the four kernels, one nvcc each, in parallel")
    for lib in _nvcc.build_all([cuda_rans.SRC, cuda_inviscid.SRC,
                                cuda_bc.SRC, cuda_irs.SRC]):
        print(f"  built {lib.relative_to(_nvcc.BUILD_DIR.parents[1])}")

    phase("[2] K1 against its plain version on small blocks; two launches "
          "bitwise equal")
    for dims in ((24, 12, 8), (23, 11, 7)):
        tensors, consts = cuda_rans.sample_operands(dims, "cuda:0")
        compare_kernel("x".join(map(str, dims)), tensors, consts, SMALL_RTOL)
    check_bitwise(tensors, consts)

    phase("[3] gradient through the kernel's autograd.Function")
    check_gradient(*cuda_rans.sample_operands((24, 12, 8), "cuda:0"))

    phase("[31] the BC pass kernel and its jvp against the float64 plain "
          f"pass on the {'x'.join(map(str, FULL_DIMS))} wing; its times")
    bc_checks, bc_times = bc_pass_checks(name)

    phase("[32] the multigrid levels' kernels at "
          f"{', '.join('x'.join(map(str, d)) for d in mg_timing.LEVELS)}: K1's "
          "coarse instantiation and the residual smoothing against their "
          "float64 plain versions; their times")
    k1_mg_checks, irs_checks, irs_times, k1_coarse_times = mg_kernel_checks()

    phase("[4] small RK solve: card against CPU")
    small_solve_parity()

    phase("[5] RK path: ADFLOW RANS-SA RK solve of the "
          f"{'x'.join(map(str, FULL_DIMS))} wing")
    solver, k1_rk, bc_rk = main_path()

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
    solver, k2_ank, bc_ank = ank_main_path()
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
    k2_times["profiled_ms"], scalar_pc_ms = ank_breakdown(solver)

    phase("[15] small adjoints: card against CPU, through K2 and K1")
    k1_adj, k2_adj = adjoint_parity()

    phase("[16] main path's adjoint: evalFunctionsSens of cl on the "
          f"{'x'.join(map(str, FULL_DIMS))} Euler wing")
    k2_full_adj = full_adjoint(solver)

    # [28] and [29] reuse [16]'s solver; [29]'s float64 solveCL runs on the
    # CPU in a process of its own meanwhile
    with ProcessPoolExecutor(
            1, mp_context=multiprocessing.get_context("spawn")) as pool:
        cl_ref = pool.submit(cl_reference)
        phase("[28] the design point's files on the "
              f"{'x'.join(map(str, FULL_DIMS))} Euler wing: mesh files, "
              "writeSolution, restart, forces, slices")
        k2_files = design_point_files(solver)
        phase("[29] the outer solves and run control: solveCL (card "
              "against CPU), solveErrorEstimate at full width, SIGUSR2, "
              "jaxProfileDir, the MPhys adapter, the volume writers")
        k2_err, k2_cl, k2_ctl = outer_solves(solver, cl_ref)
    phase(f"[30] several devices: the {'x'.join(map(str, FULL_DIMS))} wings "
          f"balanced over {STACK_SLOTS} slots under an NCCL group of one "
          "rank: the stacked residual, exchange, RK and ANK steps; the small "
          "wing card against CPU")
    k1_dist, k2_dist = dist_path(solver)
    del solver, tensors

    phase("[17] the slice at full width: matrix dissipation on the "
          f"{'x'.join(map(str, FULL_DIMS))} Euler wing, {MATRIX_STEPS} ANK "
          "steps, no kernel")
    k1_matrix, k2_matrix = matrix_path(scalar_pc_ms)

    # [19]'s float64 reference on the CPU, in a process of its own that
    # runs while the card works through [18] and [19]
    with ProcessPoolExecutor(
            1, mp_context=multiprocessing.get_context("spawn")) as pool:
        reference = pool.submit(plate_reference)
        phase("[18] small cases, card against CPU: upwind and matrix "
              "residuals, a matrix ANK step, flow-through functions, the new "
              "BCs, a mixed NK solve")
        k1_small, k2_small, k2_mixed = small_slice_parity()

        phase("[19] a turbulent plate converged on the card: precision "
              "'mixed' with NK, against a float64 solve on the CPU")
        k1_plate = plate_mixed(reference)

    phase("[20] the slice at full width: SST on the "
          f"{'x'.join(map(str, FULL_DIMS))} viscous wing, {SST_STEPS} ANK "
          "steps, K2 for the mean flow")
    k2_sst = sst_path(scalar_pc_ms)

    phase("[21] small cases, card against CPU: SST, the SA variants, wall "
          "functions, grid motion, the low-speed preconditioner, actuator "
          "sources, the grid-motion adjoint")
    k1_phys, k2_phys = small_physics_parity()
    k1_new, k2_new, irs_new = solver_slice(phase, scalar_pc_ms)
    phase("[26] overset at full width: the viscous NACA 0012 O-mesh at "
          f"{'x'.join(map(str, (OVS_NEAR['ni'], OVS_NEAR['nj'], OVS_NEAR['nk'])))}"
          " in its generated background, RANS-SA: ANK steps, the shape "
          "change (warp, re-assembly, quick wall distance), the adjoint")
    k1_ovs = overset_path()
    phase("[27] small cases, card against CPU: box-in-box with a cut, the "
          "airfoil in its background, the zipper, a user surface, cperror2, "
          "the overset adjoint, a warp with the quick wall distance")
    k1_ovs_small, k2_ovs_small = small_overset_parity()
    k1_new.update(k1_dist)
    k2_new.update(k2_dist)
    k1_new["overset_rans_airfoil_256x64x64_in_background"] = k1_ovs
    k1_new["overset_small_cases"] = k1_ovs_small
    k2_new["overset_rans_airfoil_256x64x64_in_background"] = 0
    k2_new["overset_small_cases"] = k2_ovs_small
    phase()
    print(f"total wall time {time.perf_counter() - t_start:.1f} s")

    print(card)
    print(json.dumps({"kernels": [
        {"name": "fused_rans_residual", "route": "cuda",
         "source": "adflow_torch/csrc/rans_residual.cu",
         "replaces": "adflow_tpu/ops/pallas_rans.py:58",
         "design": "one pass, i-march",
         "launches": (k1_rk + k1_ank + k1_adj + k1_matrix + k1_small
                      + k1_plate + k1_phys + sum(k1_new.values())
                      + k1_mg_checks),
         "launches_by_path": {"rk_rans_wing_256x64x64": k1_rk,
                              "coarse_checks_mg_levels": k1_mg_checks,
                              "ank_rans_wing_64x24x16": k1_ank,
                              "adjoint_rans_wing_16x8x8": k1_adj,
                              "matrix_euler_wing_256x64x64": k1_matrix,
                              "upwind_matrix_wing_16x8x8": k1_small,
                              "mixed_rans_plate_16x12": k1_plate,
                              "sst_wing_256x64x64": 0,
                              "physics_small_cases": k1_phys, **k1_new},
         "max_abs_err": max_abs, "max_rel_err": flux_rel,
         "max_rel_err_of_residual": max_rel, **k1_times,
         "coarse_by_level": k1_coarse_times, "library_ms": None},
        {"name": "fused_inviscid_residual", "route": "cuda",
         "source": "adflow_torch/csrc/inviscid_residual.cu",
         "replaces": "adflow_tpu/ops/pallas_residual.py:45",
         "design": "one pass, i-march",
         "launches": (k2_ank + k2_adj + k2_full_adj + k2_matrix + k2_small
                      + k2_mixed + k2_sst + k2_phys + sum(k2_new.values())
                      + k2_files + k2_err + k2_cl + k2_ctl),
         "launches_by_path": {"ank_euler_wing_256x64x64": k2_ank,
                              "adjoint_euler_wing_16x8x8": k2_adj,
                              "adjoint_euler_wing_256x64x64": k2_full_adj,
                              "matrix_euler_wing_256x64x64": k2_matrix,
                              "upwind_matrix_wing_16x8x8": k2_small,
                              "mixed_euler_wing_16x8x8": k2_mixed,
                              "sst_wing_256x64x64": k2_sst,
                              "physics_small_cases": k2_phys, **k2_new,
                              "files_euler_wing_256x64x64": k2_files,
                              "error_estimate_euler_wing_256x64x64": k2_err,
                              "solve_cl_euler_wing_16x8x8": k2_cl,
                              "run_control_small_cases": k2_ctl},
         "max_abs_err": k2_abs, "max_rel_err": k2_flux_rel, **k2_times,
         "library_ms": None},
        {"name": "fused_bc_pass", "route": "cuda",
         "source": "adflow_torch/csrc/bc_ghost.cu", "replaces": "none",
         "design": "one launch a subface, its tangent from the same source",
         "launches": bc_checks + bc_rk + bc_ank,
         "launches_by_path": {"bc_pass_checks_wing_256x64x64": bc_checks,
                              "rk_rans_wing_256x64x64": bc_rk,
                              "ank_euler_wing_256x64x64": bc_ank},
         **bc_times, "library_ms": None},
        {"name": "residual_averaging", "route": "cuda",
         "source": "adflow_torch/csrc/residual_averaging.cu",
         "replaces": "none",
         "design": "one launch an axis, a thread a line and its channels",
         "launches": irs_checks + sum(irs_new.values()),
         "launches_by_path": {"checks_mg_levels": irs_checks, **irs_new},
         "max_rel_err": max(t["rel_err"] for t in irs_times.values()),
         **{k: irs_times["x".join(map(str, FULL_DIMS))][k]
            for k in ("ms", "plain_ms", "bound_ms")},
         "by_level": irs_times, "library_ms": None},
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
