"""The user-facing solver class (counterpart of adflow_tpu/api/solver.py;
reference class ``ADFLOW``, adflow/pyADflow.py:60).

The port runs every solver branch of ``__call__``: the ANK/NK driver (the
default, solvers/newton.py) with the line or the multigrid (AMG) global
preconditioner; the Runge-Kutta and DADI smoothers
(``useANKSolver: False, useNKSolver: False``); FAS multigrid
(``MGCycle`` '2w', '3v', '3w', ...) and the full-multigrid start
(``MGStartLevel``); ``equationMode`` 'unsteady' (BDF dual time and
explicit RK4) and 'time spectral' with its stability derivatives. Besides:
``evalFunctions``, residual and state access; and the discrete adjoint
(adjoint/api.py): ``solveAdjoint``, ``evalFunctionsSens``,
``computeJacobianVectorProductFwd/Bwd``, ``solveAdjointForRHS`` and
``solveDirectForRHS``, which take numpy arrays or tensors and return numpy
arrays, as the JAX package's do. Overset meshes (an OVERSET face or a
``cutCallback``; implicit or explicit hole cut, the zipper and the overlap
weights), user integration surfaces (``addIntegrationSurface``), cp-target
inverse design (``setTargetCp``) and the geometry interface
(``setSurfaceCoordinates``/``updateGeometryInfo`` with the IDW warp, the
overset re-assembly and the quick wall-distance update; ``getGrid``/
``setGrid``; ``checkMeshQuality``, ``checkOverset``) run as in the JAX
package. So do the files and the outer solves: a mesh file through
``gridFile`` (io/meshio.py), solution files and restart, forces, BC data,
the slice, lift, Tecplot and isosurface writers and the family and user
functions (api/output.py); ``solveCL``, ``solveTargetFuncs``,
``solveTrimCL``, ``solveSep``, ``solveErrorEstimate`` and
``propagateUncertainty``; and run control, the SIGUSR1/SIGUSR2 handlers of
a solve (utils/signals.py) and its profiler trace (``jaxProfileDir``, kept
by name). The solver runs on ``cuda:0`` unless the caller passes another
device (the tests pass ``device="cpu"``); it never falls back to the CPU on
its own.

Several devices (``meshDevices`` N > 1) run one process per device, as
ADflow runs one MPI rank per core: start N processes (``torchrun
--nproc_per_node=N``), initialize ``torch.distributed`` (NCCL on cards,
gloo on the CPU) and construct ``ADFLOW`` on each; ``comm`` is the
process group (None: the default group), whose size must be N. Each rank
takes ``cuda:{LOCAL_RANK}`` unless given a device. Construction splits
and orders the blocks so each rank owns an equal slice of the stacked
block axis (dist/stacked.py ``balance_blocks``); the steady solve runs
the stacked RK start and stacked ANK over the group (``_solve_stacked``),
every stop agreed across ranks, and gathers every block's state on every
rank, so everything after the solve runs unchanged on each rank. Only
rank 0 prints. ``meshAxisName`` is accepted and has no effect (the JAX
package names its device-mesh axis with it).
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import os
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from adflow_torch.api.output import OutputMixin
from adflow_torch.core.mesh import MultiBlockMesh
from adflow_torch.core.refstate import (
    GAMMA, AeroProblem, ReferenceState, make_reference_state)
from adflow_torch.dist import comm as dcomm
from adflow_torch.geom.metrics import compute_metrics_conn
from adflow_torch.options import Options
from adflow_torch.physics.residual import (
    MeshTopology, ProblemConfig, build_topology, fill_halos, residual_list)
from adflow_torch.physics.surface import (
    FLOW_THROUGH_BCS, build_wall_patches, cost_functions, flow_through,
    integrate_forces, wall_sensors)
from adflow_torch.physics.usersurf import integrate_user_surface
from adflow_torch.solvers import steady
from adflow_torch.solvers.smoothers import residual_norms
from adflow_torch.utils import trace
from adflow_torch.utils.dtypes import resolve_dtype


def _mesh_group(comm, n_dev: int):
    """The process group of a ``meshDevices`` = ``n_dev`` > 1 solver:
    ``comm``, or the default group when it is None; its size must be
    ``n_dev``."""
    import torch.distributed as dist

    if comm is None:
        if not (dist.is_available() and dist.is_initialized()):
            raise ValueError(
                f"meshDevices={n_dev} runs one process per device: "
                f"initialize torch.distributed (e.g. under torchrun) or "
                f"pass a process group as comm")
        comm = dist.group.WORLD
    if not isinstance(comm, dist.ProcessGroup):
        raise ValueError(f"meshDevices={n_dev} takes a torch.distributed "
                         f"process group as comm, not {type(comm).__name__}")
    size = dist.get_world_size(comm)
    if size != n_dev:
        raise ValueError(
            f"meshDevices={n_dev} but the process group has {size} ranks")
    return comm


def _rank_device(group) -> str:
    """This rank's card: cuda:{LOCAL_RANK}, else rank % device count."""
    if group is None:
        return "cuda:0"
    local = os.environ.get("LOCAL_RANK")
    idx = (int(local) if local is not None
           else dcomm.world(group)[0] % torch.cuda.device_count())
    return f"cuda:{idx}"


class _IterMonitor:
    """Per-iteration convergence table driven by the ``monitorVariables``
    option (reference: convergenceInfo, solvers.F90:1050-1238)."""

    _KNOWN = ("cpu", "resrho", "resturb", "totalr", "cl", "cd", "cmx",
              "cmy", "cmz", "cfl", "linres", "itertype")
    _FUNC_VARS = ("cl", "cd", "cmx", "cmy", "cmz")

    def __init__(self, solver, variables):
        self.solver = solver
        vl = []
        for v in variables:
            v = str(v).lower()
            if v in self._KNOWN and v not in vl:
                vl.append(v)
        if "resrho" not in vl:
            vl.insert(0, "resrho")
        self.vars = vl
        self.needs_state = any(v in self._FUNC_VARS for v in vl)
        self.t0 = time.time()
        self._header = False

    def _functions(self, w_list):
        s = self.solver
        # the f64 continuation of precision='mixed' reports f64 states: the
        # functions are those of the solver's own dtype and metrics
        w_list = [w.to(s.dtype) for w in w_list]
        wf = fill_halos(w_list, s.metrics_list, s.topo, s.ref, s.winf)
        f = integrate_forces(wf, s.x_list, s.metrics_list, s.wall_patches,
                             s.ref, s.cfg, iblank_list=s._iblank_list(),
                             extras_list=s.extras_list,
                             patch_weights=s.wall_patch_weights)
        return {k: float(v) for k, v in cost_functions(f, s.ref).items()
                if v.ndim == 0}

    def __call__(self, it, rm, rt, w_list=None, cfl=None, linres=None,
                 itertype=""):
        funcs = None
        if self.needs_state and w_list is not None:
            funcs = self._functions(w_list)
        if not self._header:
            print(" ".join(["  iter", "type  "]
                           + [f"{v:>12s}" for v in self.vars]))
            self._header = True
        cols = [f"{it:6d}", f"{itertype:<6s}"]
        for v in self.vars:
            if v == "cpu":
                cols.append(f"{time.time() - self.t0:12.3f}")
            elif v == "resrho":
                cols.append(f"{rm:12.6e}")
            elif v == "resturb":
                cols.append(f"{rt:12.6e}")
            elif v == "totalr":
                cols.append(f"{(rm ** 2 + rt ** 2) ** 0.5:12.6e}")
            elif v == "cfl":
                cols.append(f"{cfl:12.4g}" if cfl is not None else " " * 12)
            elif v == "linres":
                cols.append(f"{linres:12.4g}" if linres is not None
                            else " " * 12)
            elif v == "itertype":
                cols.append(f"{itertype:>12s}")
            elif funcs is not None and v in funcs:
                cols.append(f"{float(funcs[v]):12.6f}")
            else:
                cols.append(" " * 12)
        print(" ".join(cols))


class ADFLOW(OutputMixin):
    """The solver with the reference's Python API surface, on PyTorch."""

    def __init__(self, options: Optional[dict] = None,
                 mesh: Optional[MultiBlockMesh] = None,
                 comm=None, debug: bool = False, device=None, **kwargs):
        self.options = Options(options or {})
        # several devices: one process per device in ``comm``'s group
        n_dev = int(self.options["meshDevices"])
        self._group = _mesh_group(comm, n_dev) if n_dev > 1 else None
        self._rank = dcomm.world(self._group)[0]
        if device is None:
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "ADFLOW runs on cuda:0 and no CUDA device is present; "
                    "pass device='cpu' to run on the CPU")
            device = _rank_device(self._group)
        self.device = torch.device(device)
        self.dtype = resolve_dtype(self.options["precision"], self.device)

        if mesh is None:
            from adflow_torch.io.meshio import read_mesh
            mesh = read_mesh(self.options["gridFile"])
        mesh.validate()
        # split and order the blocks so each rank owns an equal slice of
        # the stacked block axis (the reference's loadBalanceGrid,
        # loadBalance.F90:5); the solve then runs the stacked path
        # (_solve_stacked), everything else sees the split mesh normally
        self._stack_order = None
        if n_dev > 1:
            from adflow_torch.dist.stacked import balance_blocks
            mesh, self._stack_order = balance_blocks(mesh, n_dev)
        self.mesh = mesh
        # overset assembly (reference preprocessingoverset -> oversetComm,
        # oversetAPI.F90:7; the explicit cut callback of pyADflow.py:4370)
        self._cut_cb = kwargs.pop("cutCallback", None)
        self.topo: MeshTopology = build_topology(
            mesh, cut_callback=self._cut_cb, dtype=self.dtype,
            device=self.device)
        self.x_list = [torch.as_tensor(b.x, dtype=self.dtype,
                                       device=self.device)
                       for b in mesh.blocks]
        # the multigrid levels of these coordinates (``_mg_levels``)
        self._mg_cache = None
        # true ghost metrics at b2b faces (xhalo analogue, metrics.py)
        self.metrics_list = compute_metrics_conn(mesh.blocks, self.x_list)
        self._metrics_base = list(self.metrics_list)
        self._check_volumes()

        opt = self.options
        eq = opt["equationType"].lower()
        # turbResScale: None -> model default (reference pyADflow.py:6574)
        trs = opt["turbResScale"]
        turb_model = opt["turbulenceModel"].lower()
        if trs is None:
            trs = ((1e3, 1e-6) if turb_model == "sst"
                   else 1e4 if eq == "rans" else 1.0)
        elif isinstance(trs, (list, tuple)):
            trs = tuple(float(v) for v in trs)
        else:
            trs = float(trs)
        self.cfg = ProblemConfig(
            equation_type=eq,
            vis2=float(opt["vis2"]),
            vis4=float(opt["vis4"]),
            diss_exponent=float(opt["dissipationScalingExponent"]),
            discretization=opt["discretization"].lower(),
            limiter=opt["limiter"].lower(),
            entropy_fix=float(opt["entropyFix"]),
            riemann_solver=str(opt["riemannSolver"]).lower(),
            turbulence_model=turb_model,
            turb_order=str(opt["turbulenceOrder"]).lower(),
            turb_res_scale=trs,
            use_ft2=bool(opt["useft2SA"]),
            use_rotation_sa=bool(opt["useRotationSA"]),
            use_qcr=bool(opt["useQCR"]),
            use_kernels=bool(opt["useBlockettes"]),
        )
        assert abs(float(opt["gammaConstant"]) - GAMMA) < 1e-12
        self.wall_patches = build_wall_patches(mesh)
        self.flow_patches = build_wall_patches(mesh, include=FLOW_THROUGH_BCS)
        # overlap weights of overset wall patches and, with useZipperMesh,
        # the zipper's gap triangles (overset/assembly.py)
        self.wall_patch_weights = None
        self.zipper_gaps = None
        if self.topo.overset is not None:
            self._overset_surfaces(mesh)

        # wall distance for RANS (reference: wallDistance.F90:129), with the
        # point -> wall element association of the quick update
        # (useApproxWallDistance, updateWallDistancesQuickly)
        self._user_surfaces = []      # addIntegrationSurface
        self._cp_targets = None       # setTargetCp
        self._extra_funcs = {}        # addFunction, addUserFunction
        self._lift_dists = []         # addLiftDistribution
        self._slices = []             # addSlices
        self._sol_counter: Dict[str, int] = {}   # writeSolution numbering
        self.extras_list = None
        self._walldist_assoc = None
        if self.cfg.rans:
            from adflow_torch.geom.walldist import compute_wall_distances
            d_list, self._walldist_assoc = compute_wall_distances(
                mesh, self.x_list, cutoff=float(opt["wallDistCutoff"]),
                return_assoc=True)
            self.extras_list = [{"walldist": d} for d in d_list]

        self.curAP: Optional[AeroProblem] = None
        self.ref: Optional[ReferenceState] = None
        self.winf = None
        self.w_list: Optional[List[torch.Tensor]] = None
        self._ap_states: Dict[str, list] = {}
        self._ap_winfs: Dict[str, object] = {}
        self.solve_info = None

    def _overset_surfaces(self, mesh):
        """The overlap weights of the wall patches and, with
        ``useZipperMesh``, the zipper's gap triangles, from ``mesh``'s
        coordinates (host numpy)."""
        from adflow_torch.overset.assembly import (
            build_zipper_gaps, overlap_surface_weights)
        self.wall_patch_weights = overlap_surface_weights(
            mesh, self.wall_patches)
        self.zipper_gaps = (
            build_zipper_gaps(mesh, self.wall_patches,
                              self.wall_patch_weights)
            if bool(self.options["useZipperMesh"]) else None)

    def _iblank_list(self):
        return [bs.iblank for bs in self.topo.blocks]

    # ------------------------------------------------------------------
    def _check_volumes(self):
        for i, m in enumerate(self.metrics_list):
            vmin = float(torch.min(m.vol[2:-2, 2:-2, 2:-2]))
            if vmin <= 0.0:
                raise ValueError(
                    f"block {i} ('{self.mesh.blocks[i].name}') has "
                    f"non-positive cell volume {vmin} — left-handed or "
                    f"degenerate mesh")

    def _fresh(self):
        return [self.winf.expand(tuple(d + 4 for d in b.dims)
                                 + (self.ref.nw,)).clone()
                for b in self.mesh.blocks]

    # ------------------------------------------------------------------
    def setAeroProblem(self, ap: AeroProblem):
        """Reference: pyADflow.setAeroProblem:3240 (state stash per AP)."""
        if self.curAP is ap:
            return
        if self.curAP is not None and self.w_list is not None:
            self._ap_states[self.curAP.name] = self.w_list
            self._ap_winfs[self.curAP.name] = getattr(
                self, "_state_winf", None)
        self.curAP = ap
        self.ref = make_reference_state(
            ap, lift_index=int(self.options["liftIndex"]),
            n_turb=self.cfg.n_turb,
            eddy_vis_inf_ratio=float(self.options["eddyVisInfRatio"]))
        if bool(self.options["useWallFunctions"]) and self.cfg.viscous:
            # the wall-function wall treatment (computeUtau; physics/bc.py)
            self.ref = dataclasses.replace(self.ref, wall_fn=True)
        if bool(self.options["lowSpeedPreconditioner"]):
            # the Weiss-Smith beta^2 cutoff at the problem's free-stream
            # Mach (residuals.F90:172)
            self.cfg = dataclasses.replace(self.cfg,
                                           ls_precon_mach=float(ap.mach))
        self.winf = torch.as_tensor(self.ref.winf(), dtype=self.dtype,
                                    device=self.device)
        self._attach_grid_motion(ap)
        if ap.name in self._ap_states:
            self.w_list = self._ap_states[ap.name]
            self._state_winf = self._ap_winfs.get(
                ap.name, getattr(self, "_state_winf", None))
        else:
            self.resetFlow(ap)
        self._inf_change_correction()

    def _attach_grid_motion(self, ap: AeroProblem):
        """Rigid grid motion from the problem's rotation rate and centre and
        its machGrid (reference gridVelocitiesFineLevel, solverUtils.F90:358
        and :414): ALE face velocities on the metrics, the rate made
        nondimensional by a_inf (the grid is in metres) and the translation
        -machGrid along the free-stream direction. The f64 metrics of
        precision='mixed' stay static, as in the JAX package."""
        mach_grid = float(getattr(ap, "machGrid", 0.0) or 0.0)
        if getattr(ap, "rotRate", None) is None and mach_grid == 0.0:
            self.metrics_list = list(self._metrics_base)
            return
        from adflow_torch.geom.metrics import add_grid_motion
        om = (np.asarray(ap.rotRate, float) / ap.a_dim
              if ap.rotRate is not None else np.zeros(3))
        vtrans = -mach_grid * np.asarray(self.ref.vel_dir, float)
        self.metrics_list = [
            add_grid_motion(m, x, om, ap.rotCenter, vtrans)
            for m, x in zip(self._metrics_base, self.x_list)]

    def resetFlow(self, ap: Optional[AeroProblem] = None):
        """Free-stream or restart-file initialization (reference: initFlow,
        initializeFlow.F90:345; the restart read of variableReading.F90)."""
        if ap is not None and self.curAP is not ap:
            self.setAeroProblem(ap)
        if self.options["restartFile"]:
            self._load_restart()
            self._fresh_state = False
            self._state_winf = np.asarray(self.ref.winf())
            return
        self.w_list = self._fresh()
        self._fresh_state = True
        self._state_winf = np.asarray(self.ref.winf())

    def _inf_change_correction(self):
        """Adjust the existing state to a changed free stream (reference:
        initializeFlow.F90:191 infChangeCorrection): 'offset' adds the
        conservative winf delta to every interior cell; 'rotate' rotates
        and rescales cell velocities and offsets rho/rhoE."""
        opt = self.options
        old = getattr(self, "_state_winf", None)
        wnew = np.asarray(self.ref.winf())
        if (not bool(opt["infChangeCorrection"]) or old is None
                or self.w_list is None or len(old) != len(wnew)):
            self._state_winf = wnew
            return
        d = wnew[:5] - np.asarray(old)[:5]
        if np.linalg.norm(d) < float(opt["infChangeCorrectionTol"]):
            self._state_winf = wnew
            return
        dvec = torch.as_tensor(d, dtype=self.dtype, device=self.device)
        out = []
        if str(opt["infChangeCorrectionType"]).lower() == "offset":
            for w in self.w_list:
                w = w.clone()
                w[2:-2, 2:-2, 2:-2, :5] += dvec
                out.append(w)
            self.w_list = out
        else:
            v1 = np.asarray(old)[1:4] / max(float(old[0]), 1e-30)
            v2 = wnew[1:4] / max(float(wnew[0]), 1e-30)
            m1 = np.linalg.norm(v1)
            m2 = np.linalg.norm(v2)
            if m1 > 1e-14 and m2 > 1e-14:
                a = v1 / m1
                b = v2 / m2
                c = float(np.dot(a, b))
                k = np.cross(a, b)
                s = np.linalg.norm(k)
                if s < 1e-14:
                    R = np.eye(3) * (1.0 if c > 0 else -1.0)
                else:
                    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]],
                                  [-k[1], k[0], 0]]) / s
                    R = (np.eye(3) + s * K + (1 - c) * (K @ K))
                Rt = torch.as_tensor(R * (m2 / max(m1, 1e-30)),
                                     dtype=self.dtype, device=self.device)
                for w in self.w_list:
                    w = w.clone()
                    wi = w[2:-2, 2:-2, 2:-2]
                    rho_n = wi[..., 0:1] + dvec[0]
                    vn = torch.einsum("ab,ijkb->ijka", Rt,
                                      wi[..., 1:4] / wi[..., 0:1])
                    wi[..., 1:4] = rho_n * vn
                    wi[..., 0] += dvec[0]
                    wi[..., 4] += dvec[4]
                    out.append(w)
                self.w_list = out
        self._state_winf = wnew

    # ------------------------------------------------------------------
    @trace.spanned("api.solve")
    def __call__(self, ap: AeroProblem, **kwargs):
        """Solve (reference: ADFLOW.__call__:1185). ``nTimeSteps`` overrides
        nTimeStepsFine for 'unsteady'; ``alphaAmplitude`` (degrees, else
        the problem's ``deltaAlpha``) pitches the 'time spectral'
        instances."""
        self.setAeroProblem(ap)
        opt = self.options
        t0 = time.time()

        monitor = None
        if opt["printIterations"] and self._rank == 0:
            mv = (opt["monitorVariables"] if opt["setMonitor"]
                  else ["resrho", "resturb"])
            monitor = _IterMonitor(self, mv)
        tl = float(opt["timeLimit"])
        deadline = (t0 + tl) if tl > 0.0 else None

        mode = opt["equationMode"].lower()
        if mode == "unsteady":
            self._solve_unsteady(ap, opt, kwargs, t0)
            return
        if mode == "time spectral":
            self._solve_time_spectral(ap, opt, kwargs, t0, monitor)
            return

        # SIGUSR1 writes the current iterate and goes on, SIGUSR2 writes it
        # and stops (reference connect_signals.c:23-47, polled at
        # solvers.F90:1174); jaxProfileDir traces the solve
        from adflow_torch.utils.signals import SignalMonitor

        def _sig_write(w_now):
            # the solve's current iterate, not the pre-solve state
            if w_now is not None:
                self.w_list = list(w_now)
            self.writeSolution(baseName=f"{ap.name}_sig")

        with SignalMonitor(on_write=_sig_write) as sigmon, \
                self._profiler(opt["jaxProfileDir"]):
            info = self._solve_steady(opt, monitor, deadline, sigmon.check)
        self._fresh_state = False
        self.solve_info = info
        ap.solveFailed = bool(info.failed)
        ap.fatalFail = bool(info.failed)
        if opt["printTiming"] and self._rank == 0:
            print(f"  solve wall time: {time.time() - t0:.2f} s "
                  f"({info.iterations} iterations, "
                  f"R {info.total_r0:.3e} -> {info.total_r_final:.3e})")

    def _solve_steady(self, opt, monitor, deadline, signal_check):
        """The steady branch of ``__call__``: the full-multigrid start,
        then the stacked solve over the ranks (``meshDevices > 1``), the
        ANK/NK solver, FAS multigrid or the RK/DADI smoother.
        Sets the state and returns the SolveInfo."""
        self._fmg_start(opt)
        use_nk = bool(opt["useNKSolver"])
        use_ank = bool(opt["useANKSolver"])
        if int(opt["meshDevices"]) > 1:
            w_list, info = self._solve_stacked(opt, monitor, deadline)
        elif use_nk or use_ank:
            from adflow_torch.solvers.newton import solve_newton_driver
            w_list, info = solve_newton_driver(
                self.w_list, self.metrics_list, self.topo, self.cfg,
                self.ref, self.winf, opt, extras_list=self.extras_list,
                monitor=monitor, deadline=deadline,
                signal_check=signal_check, mixed_data=self._mixed_data())
        elif str(opt["MGCycle"]).lower() not in ("sg", "none", ""):
            from adflow_torch.solvers.multigrid import (parse_mg_cycle,
                                                        solve_mg)
            levels = self._mg_levels(
                parse_mg_cycle(str(opt["MGCycle"]))[0])
            w_list, info = solve_mg(
                self.w_list, levels, self.cfg,
                self.ref, self.winf, mg_cycle=str(opt["MGCycle"]),
                cfl=float(opt["CFL"]), n_cycles=int(opt["nCycles"]),
                l2_conv=float(opt["L2Convergence"]),
                l2_conv_rel=float(opt["L2ConvergenceRel"]),
                monitor=monitor,
                n_pre=int(opt["nMGFine"]), n_post=int(opt["nMGCoarse"]),
                cfl_coarse=float(opt["CFLCoarse"]),
                res_averaging=str(opt["resAveraging"]),
                smooth_param=float(opt["smoothParameter"]),
                deadline=deadline, vis2_coarse=float(opt["vis2Coarse"]),
                coarse_disc=str(opt["coarseDiscretization"]))
        else:
            w_list, info = steady.solve_rk(
                self.w_list, self.metrics_list, self.topo, self.cfg,
                self.ref, self.winf,
                cfl=float(opt["CFL"]), n_cycles=int(opt["nCycles"]),
                l2_conv=float(opt["L2Convergence"]),
                l2_conv_rel=float(opt["L2ConvergenceRel"]),
                extras_list=self.extras_list, monitor=monitor,
                smoother=str(opt["smoother"]), deadline=deadline,
                signal_check=signal_check)
        self.w_list = w_list
        return info

    def _solve_stacked(self, opt, monitor, deadline):
        """The several-device steady solve: this rank's slots of the
        stacked blocks, RK start then stacked ANK with the SER CFL
        controller (dist/stacked.py), every Krylov reduction and norm over
        the process group (the reference's MPI domain decomposition and
        parallel PETSc KSP). Every stop is agreed: the norms are reduced,
        and the deadline is an all-reduced flag. Returns the whole state
        list, gathered on every rank, and the SolveInfo."""
        from adflow_torch.dist import stacked as dstk

        mode = str(opt["haloExchangeMode"]).lower()
        if mode != "gather":
            raise NotImplementedError(
                "the API multi-device route uses the stacked-blocks layout "
                "(haloExchangeMode='gather'); the k-split ring is available "
                "through adflow_torch.dist.sharded for single-block meshes")
        group = self._group
        warped = self._warped_mesh()
        prob = dstk.build_stacked_problem(warped, self._stack_order,
                                          group=group, dtype=self.dtype,
                                          device=self.device)
        sm = dstk.stack_metrics(warped, prob, self.dtype,
                                metrics_all=self._metrics_base)
        extras = None
        if self.cfg.rans:
            extras = {"walldist": dstk.stack_walldist(
                warped, prob, [ex["walldist"] for ex in self.extras_list],
                self.dtype)}
        winf = self.winf
        w = dstk.stack_from_list(prob, self.w_list, winf, self.dtype)

        n_cycles = int(opt["nCycles"])
        use_ank = bool(opt["useANKSolver"])
        rk = dstk.make_stacked_rk_step(prob, self.cfg, self.ref,
                                       cfl=float(opt["CFL"]))
        m_sub = int(opt["ANKSubspaceSize"])
        m_sub = max(m_sub, 1) if m_sub > 0 else 50
        report = monitor if (monitor and not monitor.needs_state) else None

        def out_of_time():
            return deadline is not None and dcomm.agreed(
                time.time() >= deadline, group)

        hist = []
        it = 0
        failed = False
        r0 = rnorm = None
        ank_switch_rel = float(opt["ANKSwitchTol"])
        target_rel = float(opt["L2Convergence"])
        # RK start until the ANK window
        while it < n_cycles:
            w, norms = rk(w, sm, winf, extras)
            nm, nt = norms.tolist()
            rnorm = nm + nt
            it += 1
            if r0 is None:
                r0 = rnorm
            hist.append([rnorm, 0.0])
            if report:
                report(it, rnorm, 0.0, itertype="RK*")
            if not math.isfinite(rnorm):
                failed = True
                break
            if rnorm <= target_rel * r0:
                break
            if use_ank and rnorm <= ank_switch_rel * r0:
                break
            if out_of_time():
                break
        # stacked ANK with the SER CFL controller
        if use_ank and not failed and rnorm > target_rel * r0:
            cfl = float(opt["ANKCFL0"])
            cutback = float(opt["ANKCFLCutback"])
            factor = float(opt["ANKCFLFactor"])
            cfl_limit = float(opt["ANKCFLLimit"])
            lin_res_max = float(opt["ANKLinResMax"])
            n_reject = 0
            while it < n_cycles and rnorm > target_rel * r0:
                if out_of_time():
                    break
                w_new, _rn, rnew, linres = dstk.stacked_ank_step(
                    w, sm, prob, self.cfg, self.ref, winf, cfl,
                    extras=extras, m=m_sub,
                    lintol=float(opt["ANKLinearSolveTol"]))
                it += 1
                if not math.isfinite(rnew) or rnew > 10.0 * rnorm:
                    cfl = max(cfl * cutback, 1.0)
                    n_reject += 1
                    if n_reject > 25:
                        failed = True
                        break
                    continue
                n_reject = 0
                w = w_new
                rnorm = rnew
                hist.append([rnorm, 0.0])
                if report:
                    report(it, rnorm, 0.0, cfl=cfl, linres=linres,
                           itertype="ANK*")
                if linres > lin_res_max:
                    cfl = max(cfl * cutback, 1.0)
                else:
                    cfl = min(cfl * factor, cfl_limit)

        w_list = dstk.unstack_to_list(prob, dcomm.gather_stack(w, group),
                                      self.w_list)
        info = steady.SolveInfo(
            converged=bool(rnorm is not None
                           and rnorm <= target_rel * max(r0, 1e-300)),
            failed=bool(failed), iterations=it,
            total_r0=float(r0 or 0.0),
            total_r_final=float(rnorm if rnorm is not None else np.nan),
            history=np.asarray(hist) if hist else np.zeros((0, 2)))
        return w_list, info

    @contextlib.contextmanager
    def _profiler(self, trace_dir):
        """``torch.profiler`` over the solve, its Chrome trace written into
        ``trace_dir`` (the ``jaxProfileDir`` option, kept by name) as
        ``<problem>_<pid>_<ns>.pt.trace.json``; nothing without a
        directory."""
        if not trace_dir:
            yield
            return
        os.makedirs(str(trace_dir), exist_ok=True)
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        with torch.profiler.profile(activities=acts) as prof:
            yield
        prof.export_chrome_trace(os.path.join(
            str(trace_dir), f"{self.curAP.name}_{os.getpid()}_"
            f"{time.time_ns()}.pt.trace.json"))

    def _solve_unsteady(self, ap, opt, kwargs, t0):
        """The time-accurate branch: BDF dual time or explicit RK4 from the
        current state. Sets ``unsteady_info`` (not ``solve_info``) and, as
        in the JAX package, returns before the full-multigrid start and
        leaves ``_fresh_state`` as it was."""
        from adflow_torch.solvers.unsteady import (
            solve_unsteady_bdf, solve_unsteady_explicit_rk)
        n_steps = int(kwargs.get("nTimeSteps", opt["nTimeStepsFine"]))
        if opt["timeIntegrationScheme"].lower().startswith("bdf"):
            self.w_list, uinfo = solve_unsteady_bdf(
                self.w_list, self.metrics_list, self.topo, self.cfg,
                self.ref, self.winf, n_steps=n_steps,
                dt=float(opt["deltaT"]), order=int(opt["timeAccuracy"]),
                extras_list=self.extras_list, cfl=float(opt["CFL"]))
        else:
            self.w_list, uinfo = solve_unsteady_explicit_rk(
                self.w_list, self.metrics_list, self.topo, self.cfg,
                self.ref, self.winf, n_steps=n_steps,
                dt=float(opt["deltaT"]), extras_list=self.extras_list)
        self.unsteady_info = uinfo
        ap.solveFailed = ap.fatalFail = bool(uinfo.failed)
        if opt["printTiming"]:
            print(f"  unsteady: {uinfo.n_steps} steps to "
                  f"t={uinfo.times[-1]:.4f}, wall {time.time() - t0:.2f} s")

    def _solve_time_spectral(self, ap, opt, kwargs, t0, monitor):
        """The time-spectral branch: ``timeIntervals`` instances from their
        own free streams, pitched in alpha. Keeps ``ts_states`` and
        ``ts_refs``, leaves ``w_list`` as instance 0 and, with a pitch and
        omegaFourier > 0, the stability derivatives for
        ``evalFunctions``."""
        from adflow_torch.solvers.timespectral import (
            instance_refstates, solve_time_spectral, stability_derivatives)
        n_inst = int(opt["timeIntervals"])
        omega = float(opt["omegaFourier"])
        amp = float(kwargs.get("alphaAmplitude",
                               getattr(ap, "deltaAlpha", 0.0)))
        refs, period = instance_refstates(ap, n_inst, omega, amp,
                                          int(opt["liftIndex"]),
                                          self.cfg.n_turb)
        winfs = [torch.as_tensor(r.winf(), dtype=self.dtype,
                                 device=self.device) for r in refs]
        w_inst = [[wq.expand(tuple(d + 4 for d in b.dims)
                             + (self.ref.nw,)).clone()
                   for b in self.mesh.blocks] for wq in winfs]
        w_inst, info = solve_time_spectral(
            w_inst, self.metrics_list, self.topo, self.cfg, refs, winfs,
            period, extras_list=self.extras_list, cfl=float(opt["CFL"]),
            n_cycles=int(opt["nCycles"]),
            l2_conv=float(opt["L2Convergence"]), monitor=monitor)
        self.ts_states = w_inst
        self.ts_refs = refs
        self.w_list = w_inst[0]
        self.solve_info = info
        # the stability derivatives (reference inputTSStabDeriv TSAlphaMode
        # cost functions cl0/clalpha/clalphadot/...): cl, cd and cmz per
        # instance, Fourier-fit against alpha(t)
        self._ts_stab = None
        if amp > 0.0 and omega > 0.0 and not info.failed:
            coeffs = {"cl": [], "cd": [], "cmz": []}
            for q in range(n_inst):
                wfq = fill_halos(w_inst[q], self.metrics_list, self.topo,
                                 refs[q], winfs[q])
                cq = cost_functions(integrate_forces(
                    wfq, self.x_list, self.metrics_list, self.wall_patches,
                    refs[q], self.cfg, iblank_list=self._iblank_list(),
                    extras_list=self.extras_list,
                    patch_weights=self.wall_patch_weights), refs[q])
                for k in coeffs:
                    coeffs[k].append(float(cq[k]))
            self._ts_stab = stability_derivatives(
                coeffs, [r.alpha for r in refs], omega, period, ap.mach,
                ap.chordRef)
        ap.solveFailed = ap.fatalFail = bool(info.failed)
        if opt["printTiming"]:
            print(f"  time spectral: {n_inst} instances, "
                  f"{info.iterations} iters, R {info.total_r0:.3e} -> "
                  f"{info.total_r_final:.3e}, wall {time.time() - t0:.2f} s")

    def _mixed_data(self):
        """f64 companions for the f64 continuation of precision='mixed'
        (solvers/newton.py): metrics recomputed from the original node
        coordinates in f64, since upcast f32 metrics would put a ~1e-7
        flux-closure floor on the f64 residual itself, and f64 wall
        distances for RANS (without the wallDistCutoff, as in the JAX
        package). Both cached; on the solver's device."""
        if self.options["precision"].lower() != "mixed":
            return None
        if getattr(self, "_mixed_cache", None) is None:
            x64 = [torch.as_tensor(b.x, dtype=torch.float64,
                                   device=self.device)
                   for b in self.mesh.blocks]
            metrics64 = compute_metrics_conn(self.mesh.blocks, x64)
            extras64 = None
            if self.cfg.rans:
                from adflow_torch.geom.walldist import compute_wall_distances
                extras64 = [{"walldist": d}
                            for d in compute_wall_distances(self.mesh, x64)]
            self._mixed_cache = (metrics64, extras64)
        metrics64, extras64 = self._mixed_cache
        winf64 = torch.as_tensor(self.ref.winf(), dtype=torch.float64,
                                 device=self.device)
        return metrics64, winf64, extras64

    def _fmg_start(self, opt):
        """Full-multigrid start (reference: the mgStartLevel groundLevel
        loop, solvers.F90:63, and the transfer transferToFineGrid:326):
        converge cheap agglomerated coarse problems with the Newton driver
        (the nCyclesCoarse / L2ConvergenceCoarse budgets) and prolong the
        result as the fine grid's initial state. Runs only from a uniform
        free-stream state (MGStartLevel 1 disables it; -1 starts at the
        coarsest level of the MGCycle, so never with 'sg').

        As in the JAX package, the coarse solves run the fine level's
        configuration (not the coarse-level scheme), so the residual
        kernels launch on the coarse meshes, and the levels are
        ``_mg_levels``' (mirrored ghost metrics, no wallDistCutoff)."""
        lvl_opt = int(opt["MGStartLevel"])
        if lvl_opt == 1 or not getattr(self, "_fresh_state", False):
            return
        from adflow_torch.solvers.multigrid import (
            parse_mg_cycle, prolong_correction)
        from adflow_torch.solvers.newton import solve_newton_driver
        from adflow_torch.solvers.smoothers import _with_interior

        want = (parse_mg_cycle(str(opt["MGCycle"]))[0] if lvl_opt < 0
                else max(lvl_opt, 1))
        if want < 2:
            return
        try:
            levels = self._mg_levels(want)
        except ValueError:
            return
        if len(levels) < 2:
            return
        sub = opt.replace(nCycles=int(opt["nCyclesCoarse"]),
                          L2Convergence=float(opt["L2ConvergenceCoarse"]),
                          printIterations=False)
        nw = self.ref.nw

        def fresh(level):
            return [self.winf.expand(tuple(d + 4 for d in bs.dims) + (nw,))
                    .clone() for bs in level.topo.blocks]

        self.fmg_info = []
        w_c = None
        for li in range(len(levels) - 1, 0, -1):
            level = levels[li]
            if w_c is None:
                w_c = fresh(level)
            w_c, info_c = solve_newton_driver(
                w_c, list(level.metrics_list), level.topo, self.cfg,
                self.ref, self.winf, sub,
                extras_list=(list(level.extras_list)
                             if level.extras_list else None))
            self.fmg_info.append(info_c)
            if info_c.failed:
                return   # keep the free-stream state
            fine = levels[li - 1]
            w_c = [_with_interior(wf, prolong_correction(
                       w_c[i][2:-2, 2:-2, 2:-2], fine.factors[i]))
                   for i, wf in enumerate(fresh(fine))]
        self.w_list = w_c

    def _mg_levels(self, n_levels: int):
        """The ``n_levels`` multigrid levels of the current coordinates
        (``multigrid.build_mg_levels``), built at the first call and kept,
        keyed by the dtype, the device and the level count, as the
        reference builds its coarse levels once in preprocessing
        (``createCoarseBlocks``). A change of the coordinates drops them
        (``_drop_mg_levels``). As in the JAX package, level 0 is
        built anew too, with per-block metrics and no wallDistCutoff."""
        from adflow_torch.solvers.multigrid import build_mg_levels
        key = (self.dtype, self.device, int(n_levels))
        if self._mg_cache is None or self._mg_cache[0] != key:
            self._mg_cache = None      # free the old levels first
            self._mg_cache = (key, build_mg_levels(
                self.mesh, self.x_list, self.cfg, int(n_levels)))
        return self._mg_cache[1]

    def _drop_mg_levels(self):
        """The coordinates change: the kept multigrid levels are freed."""
        self._mg_cache = None

    def addActuatorRegion(self, axis1, axis2, radius: float,
                          familyName: str = "actuator",
                          thrust: float = 0.0, torque: float = 0.0):
        """A cylindrical actuator volume from ``axis1`` to ``axis2`` of
        ``radius``, adding distributed momentum sources: the thrust along
        the axis, uniform per volume, and the torque as a tangential force
        per volume proportional to the radius (reference
        pyADflow.addActuatorRegion:831, actuatorRegion.F90; the reference
        takes a closed surface, this the common propeller-disk cylinder).
        The energy row f . u is added at each residual evaluation
        (``physics/residual.py``). Host (numpy) work, once."""
        from adflow_torch.geom.metrics import cell_centers
        axis1 = np.asarray(axis1, float)
        axvec = np.asarray(axis2, float) - axis1
        length = float(np.linalg.norm(axvec))
        axhat = axvec / max(length, 1e-30)
        if self.extras_list is None:
            self.extras_list = [{} for _ in self.mesh.blocks]
        geo = []
        vol_tot = 0.0
        for x, m in zip(self.x_list, self.metrics_list):
            rel = cell_centers(x).double().cpu().numpy() - axis1
            t = rel @ axhat
            rvec = rel - t[..., None] * axhat
            rad = np.linalg.norm(rvec, axis=-1)
            mask = (t >= 0.0) & (t <= length) & (rad <= radius)
            vol = m.vol[2:-2, 2:-2, 2:-2].double().cpu().numpy()
            geo.append((mask, vol, rvec))
            vol_tot += float(vol[mask].sum())
        if vol_tot <= 0.0:
            raise ValueError("actuator region captures no cells")
        for bi, (mask, vol, rvec) in enumerate(geo):
            src = np.zeros(vol.shape + (5,))
            src[..., 1:4] = mask[..., None] * (thrust / vol_tot * axhat) \
                * vol[..., None]
            if torque != 0.0:
                rad = np.maximum(np.linalg.norm(rvec, axis=-1), 1e-12)
                that = np.cross(np.broadcast_to(axhat, rvec.shape), rvec)
                that /= np.maximum(
                    np.linalg.norm(that, axis=-1, keepdims=True), 1e-30)
                # torque = sum f_t r V with f_t proportional to r
                f_t = torque / max(float((rad * vol * rad)[mask].sum()),
                                   1e-30)
                src[..., 1:4] += (mask[..., None] * (f_t * rad)[..., None]
                                  * that * vol[..., None])
            ex = dict(self.extras_list[bi])
            ex["act_src_momentum"] = torch.as_tensor(
                src, dtype=self.dtype, device=self.device)
            self.extras_list[bi] = ex

    def addIntegrationSurface(self, fileName, familyName: str,
                              isInflow: bool = True):
        """Add a user-defined integration surface: a triangulated surface
        inside the domain on which mass flow and mass-averaged totals are
        integrated, exposed as the cost functions ``<familyName>_mdot``,
        ``_mavgptot``, ``_mavgttot``, ``_mavgps``, ``_mavgmn`` and ``_area``
        (reference pyADflow.addIntegrationSurface:780). ``fileName`` is a
        formatted PLOT3D surface file, or a ``(pts, conn)`` tuple of vertex
        coordinates (np, 3) and quad or triangle connectivity. The
        association is made on the host, at the current coordinates."""
        from adflow_torch.physics.usersurf import (
            build_integration_surface, read_plot3d_surf)
        if isinstance(fileName, str):
            pts, conn = read_plot3d_surf(fileName)
        else:
            pts, conn = fileName
        self._user_surfaces.append(build_integration_surface(
            self.mesh, self._x_numpy(), pts, conn, familyName,
            is_inflow=isInflow))
        self._afns = None        # the adjoint's functions now include it

    def _x_numpy(self):
        return [x.detach().cpu().double().numpy() for x in self.x_list]

    # ------------------------------------------------------------------
    def _filled_w(self):
        return fill_halos(self.w_list, self.metrics_list, self.topo,
                          self.ref, self.winf)

    @trace.spanned("api.eval_functions")
    def evalFunctions(self, ap: AeroProblem, funcs: dict,
                      evalFuncs: Optional[Sequence[str]] = None,
                      ignoreMissing: bool = True):
        """Reference: pyADflow.evalFunctions:1536 — fills
        funcs['<ap.name>_<func>']."""
        self.setAeroProblem(ap)
        if evalFuncs is None:
            evalFuncs = ap.evalFuncs
        wf = self._filled_w()
        ibl = self._iblank_list()
        f = integrate_forces(wf, self.x_list, self.metrics_list,
                             self.wall_patches, self.ref, self.cfg,
                             iblank_list=ibl, extras_list=self.extras_list,
                             patch_weights=self.wall_patch_weights,
                             cp_targets=self._cp_targets,
                             zipper=self.zipper_gaps)
        f.update(wall_sensors(wf, self.metrics_list, self.wall_patches,
                              self.ref, iblank_list=ibl, x_list=self.x_list))
        if self.flow_patches:
            f.update(flow_through(wf, self.metrics_list, self.flow_patches,
                                  self.ref))
        all_funcs = cost_functions(f, self.ref)
        for surf in self._user_surfaces:
            all_funcs.update(integrate_user_surface(wf, surf, self.ref))
        if getattr(self, "_ts_stab", None):
            all_funcs.update(self._ts_stab)
        if self._extra_funcs:
            all_funcs.update(self._eval_extra_funcs(all_funcs))
        for name in evalFuncs:
            key = name.lower()
            if key in all_funcs:
                funcs[f"{ap.name}_{name}"] = float(all_funcs[key])
            elif not ignoreMissing:
                raise ValueError(f"Unknown cost function '{name}'")
        return funcs

    def getResidual(self, ap: AeroProblem):
        """Full residual list (reference: pyADflow.getResidual:5359)."""
        self.setAeroProblem(ap)
        return residual_list(self.w_list, self.metrics_list, self.topo,
                             self.cfg, self.ref, self.winf, self.extras_list)

    def getResNorms(self):
        """Current (mean-flow, turbulence) residual norms (reference
        pyADflow.getResNorms:4495)."""
        r = residual_list(self.w_list, self.metrics_list, self.topo,
                          self.cfg, self.ref, self.winf, self.extras_list)
        nm, nt = residual_norms(r)
        return float(nm), float(nt)

    # -- state access (reference: getStates:5174 / setStates:5181) -------
    def getStates(self):
        return torch.cat(
            [w[2:-2, 2:-2, 2:-2].reshape(-1) for w in self.w_list])

    @trace.spanned("api.set_states")
    def setStates(self, states):
        """Set the interior states from a flat numpy array or tensor."""
        if not torch.is_tensor(states):
            states = torch.from_numpy(np.array(states))
        states = states.to(dtype=self.dtype, device=self.device)
        out = []
        ofs = 0
        for w in self.w_list:
            interior = w[2:-2, 2:-2, 2:-2]
            n = interior.numel()
            w = w.clone()
            w[2:-2, 2:-2, 2:-2] = states[ofs:ofs + n].reshape(interior.shape)
            out.append(w)
            ofs += n
        self.w_list = out

    # ------------------------------------------------------------------
    # adjoint and derivative products (reference: pyADflow.solveAdjoint:4052,
    # evalFunctionsSens:1673, computeJacobianVectorProductFwd:4557/Bwd:4814)
    # ------------------------------------------------------------------
    def _newton_fns(self):
        """The Newton functions, built on first use and kept, as the JAX
        package keeps them: a later aero problem reuses the first one's
        reference state in the adjoint's PC."""
        from adflow_torch.solvers import newton
        if getattr(self, "_nfns", None) is None:
            self._nfns = newton.build_newton_fns(
                self.w_list, self.metrics_list, self.topo, self.cfg,
                self.ref, self.winf, self.extras_list)
        return self._nfns

    def _newton_packer(self):
        return self._newton_fns().packer

    def _adjoint_fns(self):
        """The adjoint's functions, built on first use and kept (their base
        reference state is the first aero problem's, as in the JAX
        package)."""
        from adflow_torch.adjoint.api import build_adjoint_fns
        if getattr(self, "_afns", None) is None:
            self._afns = build_adjoint_fns(self)
        return self._afns

    def _ap_params(self, ap: AeroProblem):
        """The design variables as 0-d tensors (the reference's extra-DV
        map alpha/beta/mach, P, T, Re and the reference point,
        pyADflow.py:6444-6461), and with grid motion rotRate (over a_inf,
        as the primal attaches it), rotCenter and machGrid."""
        kw = dict(dtype=self.dtype, device=self.device)
        out = {k: torch.tensor(v, **kw) for k, v in (
            ("alpha", ap.alpha), ("beta", ap.beta), ("mach", ap.mach),
            ("T", ap.T), ("P", ap.P),
            ("xref", [ap.xRef, ap.yRef, ap.zRef]))}
        if ap.reynolds and ap.reynolds > 0:
            out["reynolds"] = torch.tensor(ap.reynolds, **kw)
        if getattr(ap, "rotRate", None) is not None:
            out["rotRate"] = torch.tensor(
                np.asarray(ap.rotRate, float) / ap.a_dim, **kw)
            out["rotCenter"] = torch.tensor(ap.rotCenter, **kw)
        if float(getattr(ap, "machGrid", 0.0) or 0.0) != 0.0:
            out["machGrid"] = torch.tensor(ap.machGrid, **kw)
        return out

    def _wx_vecs(self):
        wvec = self._newton_packer().pack_w(self.w_list)
        return wvec, self._adjoint_fns().pack_x(self.x_list)

    def _as_vec(self, a):
        """A flat tensor on the solver's device and dtype from a numpy array
        or a tensor."""
        t = a if torch.is_tensor(a) else torch.tensor(np.asarray(a))
        return t.to(dtype=self.dtype, device=self.device).reshape(-1)

    def _adjoint_restarts(self):
        return max(1, int(self.options["adjointMaxIter"])
                   // int(self.options["adjointSubspaceSize"]))

    def solveAdjoint(self, ap: AeroProblem, objective: str):
        """Solve dR/dw^T psi = dI/dw for one cost function; psi is cached
        per (ap, objective) and warm-starts the next solve when
        ``restartAdjoint`` is on (reference adjointAPI.F90:742-752).
        Returns psi as a tensor on the solver's device."""
        from adflow_torch.adjoint.api import solve_adjoint_system
        self.setAeroProblem(ap)
        fns = self._adjoint_fns()
        wvec, xvec = self._wx_vecs()
        params = self._ap_params(ap)
        key = objective.lower()
        dIdw = torch.func.grad(
            lambda w: fns.funcs(w, xvec, params)[key])(wvec)
        if not hasattr(self, "_psi_cache"):
            self._psi_cache = {}
        psi0 = (self._psi_cache.get((ap.name, key))
                if bool(self.options["restartAdjoint"]) else None)
        sol = solve_adjoint_system(
            fns, self, wvec, xvec, params, dIdw, psi0=psi0,
            tol=float(self.options["adjointL2Convergence"]),
            abs_tol=float(self.options["adjointL2ConvergenceRel"]),
            subspace=int(self.options["adjointSubspaceSize"]),
            restarts=self._adjoint_restarts())
        self._psi_cache[(ap.name, key)] = sol.x
        self.adjoint_info = sol
        self.adjointFailed = not sol.converged
        return sol.x

    @trace.spanned("api.eval_functions_sens")
    def evalFunctionsSens(self, ap: AeroProblem, funcsSens: dict,
                          evalFuncs: Optional[Sequence[str]] = None):
        """Total derivatives of each function with respect to alpha, beta,
        mach, T, P, rho, xref, xv (and reynolds) by one adjoint solve each:
        dI/d* = dI/d*|direct - psi^T dR/d*."""
        from adflow_torch.core.refstate import R_GAS
        self.setAeroProblem(ap)
        if evalFuncs is None:
            evalFuncs = ap.evalFuncs
        fns = self._adjoint_fns()
        wvec, xvec = self._wx_vecs()
        params = self._ap_params(ap)
        for name in evalFuncs:
            key = name.lower()
            psi = self.solveAdjoint(ap, key)
            gI_x, gI_p = torch.func.grad(
                lambda x, p: fns.funcs(wvec, x, p)[key], argnums=(0, 1))(
                    xvec, params)
            _, vjp_xp = torch.func.vjp(
                lambda x, p: fns.res(wvec, x, p), xvec, params)
            gR_x, gR_p = vjp_xp(psi)
            tot = {k: gI_p[k] - gR_p[k] for k in params}
            sens = {k: float(tot[k])
                    for k in ("alpha", "beta", "mach", "T", "P")}
            sens["xref"] = tot["xref"].cpu().numpy()
            sens["xv"] = (gI_x - gR_x).cpu().numpy()
            # the free-stream density at constant T (reference iDV['rho'],
            # pyADflow.py:6451): rho = P / (R T), so dI/drho = R T dI/dP
            sens["rho"] = R_GAS * ap.T * sens["P"]
            if "reynolds" in params:
                sens["reynolds"] = float(tot["reynolds"])
            if "rotRate" in params:
                # taken in the rate over a_inf; reported per rad/s. The
                # concrete a_dim leaves out d(omega)/dT, as in the JAX
                # package
                sens["rotRate"] = tot["rotRate"].cpu().numpy() / ap.a_dim
                sens["rotCenter"] = tot["rotCenter"].cpu().numpy()
            if "machGrid" in params:
                sens["machGrid"] = float(tot["machGrid"])
            funcsSens[f"{ap.name}_{name}"] = sens
        return funcsSens

    def computeJacobianVectorProductFwd(self, wDot=None, xVDot=None,
                                        residualDeriv=False, funcDeriv=False,
                                        **kwargs):
        """Forward products dR/dw wDot + dR/dx xVDot and the same of the
        functions (reference adjointAPI.F90:11), exact by
        ``torch.func.jvp``; numpy out."""
        fns = self._adjoint_fns()
        wvec, xvec = self._wx_vecs()
        params = self._ap_params(self.curAP)
        wd = torch.zeros_like(wvec) if wDot is None else self._as_vec(wDot)
        xd = torch.zeros_like(xvec) if xVDot is None else self._as_vec(xVDot)
        out = []
        if residualDeriv:
            _, rdot = torch.func.jvp(lambda w, x: fns.res(w, x, params),
                                     (wvec, xvec), (wd, xd))
            out.append(rdot.cpu().numpy())
        if funcDeriv:
            _, fdot = torch.func.jvp(lambda w, x: fns.funcs(w, x, params),
                                     (wvec, xvec), (wd, xd))
            out.append({k: float(v) for k, v in fdot.items()})
        return out[0] if len(out) == 1 else tuple(out)

    def computeJacobianVectorProductBwd(self, resBar=None, funcsBar=None,
                                        wDeriv=False, xVDeriv=False,
                                        **kwargs):
        """Reverse products resBar^T dR/d(w, x) plus the gradient of the
        weighted functions (reference adjointAPI.F90:97); numpy out."""
        fns = self._adjoint_fns()
        wvec, xvec = self._wx_vecs()
        params = self._ap_params(self.curAP)
        gw, gx = torch.zeros_like(wvec), torch.zeros_like(xvec)
        if resBar is not None:
            _, vjp = torch.func.vjp(lambda w, x: fns.res(w, x, params),
                                    wvec, xvec)
            dw, dx = vjp(self._as_vec(resBar))
            gw, gx = gw + dw, gx + dx
        if funcsBar is not None:
            def weighted(w, x):
                f = fns.funcs(w, x, params)
                return sum(float(v) * f[k.lower()]
                           for k, v in funcsBar.items())
            dw, dx = torch.func.grad(weighted, argnums=(0, 1))(wvec, xvec)
            gw, gx = gw + dw, gx + dx
        out = []
        if wDeriv:
            out.append(gw.cpu().numpy())
        if xVDeriv:
            out.append(gx.cpu().numpy())
        return out[0] if len(out) == 1 else tuple(out)

    def solveAdjointForRHS(self, inVec, relTol=None):
        """Solve (dR/dw)^T psi = inVec for any right-hand side (reference
        pyADflow.solveAdjointForRHS:4222); numpy out."""
        from adflow_torch.adjoint.api import solve_adjoint_system
        if relTol is None:
            relTol = float(self.options["adjointL2Convergence"])
        fns = self._adjoint_fns()
        wvec, xvec = self._wx_vecs()
        sol = solve_adjoint_system(
            fns, self, wvec, xvec, self._ap_params(self.curAP),
            self._as_vec(inVec), tol=relTol,
            subspace=int(self.options["adjointSubspaceSize"]),
            restarts=self._adjoint_restarts())
        return sol.x.cpu().numpy()

    def solveDirectForRHS(self, inVec, relTol=None):
        """Solve the direct system (dR/dw) x = inVec (reference
        pyADflow.solveDirectForRHS:4242) by matrix-free GMRES with the line
        PC. The PC takes ``collect_pc_data``'s kappa 0.25, not the solver's
        ``linePCKappa``, as in the JAX package; numpy out."""
        from adflow_torch.adjoint.api import PC_CFL
        from adflow_torch.solvers.krylov import gmres
        from adflow_torch.solvers.newton import pc_apply_vec
        if relTol is None:
            relTol = float(self.options["adjointL2Convergence"])
        nfns = self._newton_fns()
        fns = self._adjoint_fns()
        wvec, xvec = self._wx_vecs()
        params = self._ap_params(self.curAP)

        def matvec(v):
            return torch.func.jvp(lambda w: fns.res(w, xvec, params),
                                  (wvec,), (v,))[1]

        data_list = nfns.collect_pc_data(wvec, PC_CFL)
        sol = gmres(matvec, self._as_vec(inVec),
                    m=int(self.options["adjointSubspaceSize"]),
                    restarts=self._adjoint_restarts(), tol=relTol,
                    precond=lambda v: pc_apply_vec(data_list, nfns.packer,
                                                   v))
        return sol.x.cpu().numpy()

    # ------------------------------------------------------------------
    # outer solves (reference: solveCL:1847, solveTargetFuncs:2369,
    # solveTrimCL:2236, solveSep:2516, solveErrorEstimate:5370,
    # propagateUncertainty:1784); host arithmetic on the functions' floats
    # ------------------------------------------------------------------
    def solveCL(self, ap: AeroProblem, CLStar: float, alpha0: float = 0.0,
                delta: float = 0.5, tol: float = 1e-4, maxIter: int = 20,
                autoReset: bool = False):
        """Secant iteration on alpha to a target CL; each iterate is a
        solve from the free stream. Returns the last alpha."""
        def cl_at(alpha):
            ap.alpha = alpha
            self.curAP = None          # rebuild the reference state
            self._ap_states.pop(ap.name, None)
            self(ap)
            funcs = {}
            self.evalFunctions(ap, funcs, evalFuncs=["cl"])
            return funcs[f"{ap.name}_cl"]

        a0, a1 = alpha0, alpha0 + delta
        f0 = cl_at(a0) - CLStar
        if abs(f0) < tol:
            return a0
        f1 = cl_at(a1) - CLStar
        for _ in range(maxIter):
            if abs(f1) < tol:
                return a1
            if f1 == f0:
                break
            a2 = a1 - f1 * (a1 - a0) / (f1 - f0)
            a0, f0 = a1, f1
            a1 = a2
            f1 = cl_at(a1) - CLStar
        return a1

    def _func_at(self, ap, dvs: dict, names):
        """Set the problem's scalars ``dvs``, solve and return the
        functions ``names``. With infChangeCorrection the converged state
        is kept and corrected to the new free stream (a warm start)."""
        for k, v in dvs.items():
            setattr(ap, k, float(v))
        if (bool(self.options["infChangeCorrection"])
                and self.w_list is not None and self.curAP is ap):
            self._ap_states[ap.name] = self.w_list
            self._ap_winfs[ap.name] = getattr(self, "_state_winf", None)
        else:
            self._ap_states.pop(ap.name, None)
        self.curAP = None
        self(ap)
        funcs = {}
        self.evalFunctions(ap, funcs, evalFuncs=list(names))
        return [funcs[f"{ap.name}_{n}"] for n in names]

    def solveTargetFuncs(self, ap: AeroProblem, targets: dict, dvs: dict,
                         tol: float = 1e-4, maxIter: int = 12):
        """Broyden (multi-variable secant) solve driving the functions
        ``targets`` to their values by the problem's scalars ``dvs``; the
        first Jacobian by forward differences. Returns the scalars."""
        names = list(targets)
        keys = list(dvs)
        x = np.array([float(dvs[k]) for k in keys])
        t = np.array([float(targets[n]) for n in names])
        f = np.array(self._func_at(ap, dict(zip(keys, x)), names)) - t
        J = np.zeros((len(names), len(keys)))
        for j in range(len(keys)):
            dx = max(1e-2, 1e-2 * abs(x[j]))
            xp = x.copy()
            xp[j] += dx
            fp = np.array(self._func_at(ap, dict(zip(keys, xp)), names)) - t
            J[:, j] = (fp - f) / dx
        for _ in range(maxIter):
            if np.abs(f).max() < tol:
                break
            step = np.linalg.lstsq(J, -f, rcond=None)[0]
            x = x + step
            fn = np.array(self._func_at(ap, dict(zip(keys, x)), names)) - t
            denom = float(step @ step)
            if denom > 0:              # Broyden's rank-1 update
                J = J + np.outer(fn - f - J @ step, step) / denom
            f = fn
        return dict(zip(keys, x))

    def solveTrimCL(self, ap: AeroProblem, CLStar: float,
                    trimStar: float = 0.0, alpha0: float = 0.0,
                    trimDV: str = "beta", trimFunc: str = "cmy",
                    tol: float = 1e-4, maxIter: int = 12):
        """The 2x2 trim solve: alpha to CL*, ``trimDV`` to the trim
        function's target."""
        ap.alpha = alpha0
        return self.solveTargetFuncs(
            ap, {"cl": CLStar, trimFunc: trimStar},
            {"alpha": alpha0, trimDV: getattr(ap, trimDV, 0.0)},
            tol=tol, maxIter=maxIter)

    def solveSep(self, ap: AeroProblem, sepStar: float, alpha0: float = 0.0,
                 delta: float = 0.5, tol: float = 1e-4, maxIter: int = 20):
        """Alpha for a target separation sensor; returns alpha."""
        out = self.solveTargetFuncs(ap, {"sepsensor": sepStar},
                                    {"alpha": alpha0}, tol=tol,
                                    maxIter=maxIter)
        return out["alpha"]

    def solveErrorEstimate(self, ap: AeroProblem, objective: str):
        """The adjoint-weighted residual error estimate of one function,
        -psi^T R(w), the dot product on the device in the state's dtype."""
        self.setAeroProblem(ap)
        psi = self.solveAdjoint(ap, objective.lower())
        fns = self._adjoint_fns()
        wvec, xvec = self._wx_vecs()
        r = fns.res(wvec, xvec, self._ap_params(ap))
        return -float(torch.dot(psi, r))

    def propagateUncertainty(self, ap: AeroProblem, evalFuncs, uq: dict):
        """First-order uncertainty propagation: sigma_f^2 = sum over the
        problem's variables of (df/dv sigma_v)^2. Returns {name: sigma}."""
        sens = {}
        self.evalFunctionsSens(ap, sens, evalFuncs=list(evalFuncs))
        out = {}
        for name in evalFuncs:
            key = f"{ap.name}_{name}"
            var = 0.0
            for dv, sigma in uq.items():
                d = sens.get(key, {}).get(dv, 0.0)
                var += (float(np.asarray(d).reshape(-1)[0]
                              if np.ndim(d) else d) * sigma) ** 2
            out[key] = math.sqrt(var)
        return out

    # ------------------------------------------------------------------
    # inverse design, diagnostics and the geometry interface (reference:
    # setTargetCp:3827, setSurfaceCoordinates:3208, updateGeometryInfo:4295,
    # setGrid/getGrid warping.F90:70,195)
    # ------------------------------------------------------------------
    def setTargetCp(self, CpTargets, groupName: Optional[str] = None):
        """Set the target-Cp distribution for inverse design, consumed by
        the 'cperror2' cost function (reference pyADflow.setTargetCp:3827,
        surfaceIntegrations.F90:527). ``CpTargets``: a flat array over the
        group's wall faces in patch order, each patch row-major over its
        (T1, T2) face window."""
        flat = np.asarray(CpTargets, float).ravel()
        tg = list(self._cp_targets or [None] * len(self.wall_patches))
        ofs = 0
        for i, p in enumerate(self.wall_patches):
            if groupName is not None and p.family != groupName:
                continue
            t1, t2 = [p.face_sl[a] for a in range(3) if a != p.axis]
            s1, s2 = t1.stop - t1.start, t2.stop - t2.start
            tg[i] = flat[ofs:ofs + s1 * s2].reshape(s1, s2)
            ofs += s1 * s2
        if ofs != len(flat):
            raise ValueError(
                f"CpTargets length {len(flat)} != group faces {ofs}")
        self._cp_targets = tg

    def checkMeshQuality(self, warn: bool = True):
        """Mesh quality report at the current coordinates (reference
        gridChecking.F90 blockCheck): inverted and twisted cell counts, the
        smallest volume, the largest skewness and aspect ratio."""
        from adflow_torch.geom.quality import check_mesh_quality
        rep = check_mesh_quality(self.mesh, self._x_numpy())
        if warn and not rep["ok"]:
            print(f"# WARNING mesh quality: "
                  f"{rep['n_negative_volumes']} negative volumes, "
                  f"{rep['n_twisted_cells']} twisted cells "
                  f"(min vol {rep['min_volume']:.3e})")
        return rep

    def checkPartitioning(self, nprocs: int):
        """Load-balance quality for a hypothetical ``nprocs`` devices
        (reference: pyADflow.checkPartitioning:1161 / loadBalance.F90):
        (load_imbalance, face_imbalance_placeholder) after the block
        splitting the balancer would perform."""
        from adflow_torch.dist.stacked import balance_blocks
        m2, order = balance_blocks(self.mesh, nprocs)
        sizes = np.zeros(nprocs)
        per = len(order) // nprocs
        for c in range(nprocs):
            for pos in order[c * per:(c + 1) * per]:
                if pos >= 0:
                    sizes[c] += m2.blocks[pos].n_cells
        ideal = m2.n_cells / nprocs
        imbalance = float(sizes.max() / ideal - 1.0)
        return imbalance, 0.0

    def checkOverset(self, printReport: bool = True) -> dict:
        """Overset-connectivity report (reference: the ``oversetCheck.py`` /
        ``checkZipper.py`` diagnostics): counts of compute, fringe and hole
        cells, interpolation groups, orphans and zipper gap triangles."""
        out = {"n_blocks": len(self.mesh.blocks),
               "n_cells": self.mesh.n_cells,
               "compute": self.mesh.n_cells, "fringe": 0, "hole": 0,
               "orphans": 0, "groups": 0}
        tab = self.topo.overset
        if tab is not None:
            ibl = np.concatenate([np.ravel(b) for b in tab.iblank])
            out["compute"] = int((ibl == 1).sum())
            out["fringe"] = int((ibl == -1).sum())
            out["hole"] = int((ibl == 0).sum())
            out["orphans"] = int(tab.n_orphans)
            out["groups"] = len(tab.groups)
        gaps = self.zipper_gaps
        out["zipper_gap_tris"] = 0 if gaps is None else int(gaps.n_tris)
        if printReport:
            print(f"Overset check: {out['n_blocks']} blocks, "
                  f"{out['n_cells']} cells -> {out['compute']} compute, "
                  f"{out['fringe']} fringe, {out['hole']} hole; "
                  f"{out['orphans']} orphans; "
                  f"{out['zipper_gap_tris']} zipper gap triangles")
        return out

    def getSurfaceCoordinates(self, groupName: Optional[str] = None):
        """All wall-patch node coordinates, (n, 3) numpy (reference
        getSurfaceCoordinates:3197)."""
        pts = [self.x_list[p.block][p.fnode_sl].reshape(-1, 3)
               for p in self.wall_patches]
        if not pts:
            return np.zeros((0, 3))
        return torch.cat(pts).detach().cpu().double().numpy()

    def setSurfaceCoordinates(self, coords, groupName: Optional[str] = None):
        """Stage new wall-surface node coordinates, applied (the volume warp
        and the geometry rebuild) by ``updateGeometryInfo``, like the
        reference's deferred ``_updateGeomInfo`` flag."""
        self._pending_surface = np.asarray(coords, float)
        self._geom_dirty = True
        self._drop_mg_levels()

    def updateGeometryInfo(self):
        """Warp the volume mesh to the staged surface and rebuild the
        geometry (reference updateGeometryInfo:4295). The warp's anchors
        are those of the mesh given at construction, as in the JAX
        package."""
        if not getattr(self, "_geom_dirty", False):
            return
        from adflow_torch.geom.warp import warp_mesh
        pts0 = self.getSurfaceCoordinates()
        self.x_list = warp_mesh(self.mesh, self.x_list, pts0,
                                self._pending_surface - pts0)
        self._rebuild_geometry()
        self._geom_dirty = False

    def _warped_mesh(self):
        """The mesh at the current node coordinates (its BC and connection
        data shared, only x replaced), for the host rebuilds: the overset
        donor search, the overlap weights and the zipper."""
        return MultiBlockMesh(
            blocks=[dataclasses.replace(b, x=x)
                    for b, x in zip(self.mesh.blocks, self._x_numpy())],
            name=self.mesh.name)

    def _rebuild_geometry(self):
        """Recompute the metrics, the overset table, weights and zipper,
        and the wall distance (quick with useApproxWallDistance, else the
        full search) after a change of the node coordinates; drop the
        Newton and adjoint functions and the cached adjoints, and attach
        the aero problem again. As in the JAX package, that re-attachment
        resets the flow to the free stream unless the problem's state was
        stashed by a switch of problems."""
        self._drop_mg_levels()
        self.metrics_list = compute_metrics_conn(self.mesh.blocks,
                                                 self.x_list)
        self._metrics_base = list(self.metrics_list)
        warped = None
        if self.topo.overset is not None or self._cut_cb is not None:
            # donors, weights and iblank are functions of the coordinates
            # (reference updateOversetConnectivity,
            # oversetCommUtilites.F90:1729)
            warped = self._warped_mesh()
            self.topo = build_topology(warped, cut_callback=self._cut_cb,
                                       dtype=self.dtype, device=self.device)
            if self.wall_patch_weights is not None:
                self._overset_surfaces(warped)
        if self.cfg.rans:
            from adflow_torch.geom.walldist import (
                compute_wall_distances, update_wall_distances)
            mesh_now = warped if warped is not None else self.mesh
            cutoff = float(self.options["wallDistCutoff"])
            if (bool(self.options["useApproxWallDistance"])
                    and self._walldist_assoc is not None):
                d_list = update_wall_distances(
                    mesh_now, self.x_list, self._walldist_assoc,
                    cutoff=cutoff)
            else:
                d_list, self._walldist_assoc = compute_wall_distances(
                    mesh_now, self.x_list, cutoff=cutoff, return_assoc=True)
            for ex, d in zip(self.extras_list, d_list):
                ex["walldist"] = d
        self._nfns = None
        self._afns = None
        self._psi_cache = {}
        ap, self.curAP = self.curAP, None
        if ap is not None:
            self.setAeroProblem(ap)

    def getGrid(self):
        """Flat volume-node coordinate vector in block order, numpy
        (reference getGrid, warping.F90:195)."""
        return np.concatenate([x.reshape(-1) for x in self._x_numpy()])

    def setGrid(self, flat):
        """Set all volume nodes from a flat vector and rebuild the geometry
        (reference setGrid, warping.F90:70)."""
        flat = np.asarray(flat, float)
        off = 0
        new = []
        for x in self.x_list:
            n = x.numel()
            new.append(torch.as_tensor(flat[off:off + n].reshape(x.shape),
                                       dtype=self.dtype, device=self.device))
            off += n
        self.x_list = new
        self._rebuild_geometry()

    def setOption(self, name: str, value):
        self.options = self.options.replace(**{name: value})

    def getOption(self, name: str):
        return self.options[name]


Solver = ADFLOW
