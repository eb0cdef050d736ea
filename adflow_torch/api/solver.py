"""The user-facing solver class (counterpart of adflow_tpu/api/solver.py;
reference class ``ADFLOW``, adflow/pyADflow.py:60).

This slice of the port runs the steady Runge-Kutta branch of ``__call__``
(``useANKSolver: False, useNKSolver: False``), ``evalFunctions``, residual
and state access. The solver runs on ``cuda:0`` unless the caller passes
another device (the tests pass ``device="cpu"``); it never falls back to
the CPU on its own. Every branch and option that is not ported yet raises
``NotImplementedError`` naming its ROADMAP.md item.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from adflow_torch.core.mesh import MultiBlockMesh
from adflow_torch.core.refstate import (
    GAMMA, AeroProblem, ReferenceState, make_reference_state)
from adflow_torch.geom.metrics import compute_metrics_conn
from adflow_torch.options import Options
from adflow_torch.physics.residual import (
    MeshTopology, ProblemConfig, build_topology, fill_halos, residual_list)
from adflow_torch.physics.surface import (
    FLOW_THROUGH_BCS, build_wall_patches, cost_functions, integrate_forces,
    wall_sensors)
from adflow_torch.solvers import steady
from adflow_torch.solvers.smoothers import residual_norms
from adflow_torch.utils.dtypes import resolve_dtype


def _todo(what: str, item: str):
    return NotImplementedError(
        f"{what} is not ported to adflow_torch yet (ROADMAP.md queue 1 "
        f"item {item})")


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
        wf = fill_halos(w_list, s.metrics_list, s.topo, s.ref, s.winf)
        f = integrate_forces(wf, s.x_list, s.metrics_list, s.wall_patches,
                             s.ref, s.cfg, extras_list=s.extras_list)
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


class ADFLOW:
    """The solver with the reference's Python API surface, on PyTorch."""

    def __init__(self, options: Optional[dict] = None,
                 mesh: Optional[MultiBlockMesh] = None,
                 comm=None, debug: bool = False, device=None, **kwargs):
        self.options = Options(options or {})
        if device is None:
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "ADFLOW runs on cuda:0 and no CUDA device is present; "
                    "pass device='cpu' to run on the CPU")
            device = "cuda:0"
        self.device = torch.device(device)
        self.dtype = resolve_dtype(self.options["precision"], self.device)
        self._reject_unported_options(kwargs)

        if mesh is None:
            raise _todo("reading 'gridFile'", "13")
        mesh.validate()
        self.mesh = mesh
        self.topo: MeshTopology = build_topology(
            mesh, dtype=self.dtype, device=self.device)
        self.x_list = [torch.as_tensor(b.x, dtype=self.dtype,
                                       device=self.device)
                       for b in mesh.blocks]
        # true ghost metrics at b2b faces (xhalo analogue, metrics.py)
        self.metrics_list = compute_metrics_conn(mesh.blocks, self.x_list)
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

        # wall distance for RANS (reference: wallDistance.F90:129)
        self.extras_list = None
        if self.cfg.rans:
            from adflow_torch.geom.walldist import compute_wall_distances
            d_list = compute_wall_distances(
                mesh, self.x_list, cutoff=float(opt["wallDistCutoff"]))
            self.extras_list = [{"walldist": d} for d in d_list]

        self.curAP: Optional[AeroProblem] = None
        self.ref: Optional[ReferenceState] = None
        self.winf = None
        self.w_list: Optional[List[torch.Tensor]] = None
        self._ap_states: Dict[str, list] = {}
        self._ap_winfs: Dict[str, object] = {}
        self.solve_info = None

    def _reject_unported_options(self, kwargs):
        opt = self.options
        if kwargs.get("cutCallback") is not None:
            raise _todo("overset cutCallback", "11")
        if int(opt["meshDevices"]) > 1:
            raise _todo("meshDevices > 1", "12")
        if opt["restartFile"]:
            raise _todo("restart files", "13")
        if bool(opt["useWallFunctions"]):
            raise _todo("wall functions", "9")
        if bool(opt["lowSpeedPreconditioner"]):
            raise _todo("the low-speed preconditioner", "9")
        if bool(opt["useQCR"]) or bool(opt["useRotationSA"]):
            raise _todo("QCR and rotation-SA", "9")
        if opt["turbulenceModel"].lower() != "sa":
            raise _todo(f"turbulence model {opt['turbulenceModel']!r}", "9")
        if opt["discretization"].lower() != "central plus scalar dissipation":
            raise _todo(f"discretization {opt['discretization']!r}", "9")
        if str(opt["turbulenceOrder"]).replace(" ", "").lower() != "firstorder":
            raise _todo("second-order turbulence advection", "9")
        if opt["smoother"].lower().startswith("dadi"):
            raise _todo("the DADI smoother", "10")

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
        if getattr(ap, "rotRate", None) is not None or float(
                getattr(ap, "machGrid", 0.0) or 0.0) != 0.0:
            raise _todo("grid motion (rotRate / machGrid)", "9")
        if self.curAP is not None and self.w_list is not None:
            self._ap_states[self.curAP.name] = self.w_list
            self._ap_winfs[self.curAP.name] = getattr(
                self, "_state_winf", None)
        self.curAP = ap
        self.ref = make_reference_state(
            ap, lift_index=int(self.options["liftIndex"]),
            n_turb=self.cfg.n_turb,
            eddy_vis_inf_ratio=float(self.options["eddyVisInfRatio"]))
        self.winf = torch.as_tensor(self.ref.winf(), dtype=self.dtype,
                                    device=self.device)
        if ap.name in self._ap_states:
            self.w_list = self._ap_states[ap.name]
            self._state_winf = self._ap_winfs.get(
                ap.name, getattr(self, "_state_winf", None))
        else:
            self.resetFlow(ap)
        self._inf_change_correction()

    def resetFlow(self, ap: Optional[AeroProblem] = None):
        """Free-stream initialization (reference: initFlow,
        initializeFlow.F90:345)."""
        if ap is not None and self.curAP is not ap:
            self.setAeroProblem(ap)
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
    def __call__(self, ap: AeroProblem, **kwargs):
        """Solve the steady problem (reference: ADFLOW.__call__:1185)."""
        self.setAeroProblem(ap)
        opt = self.options
        t0 = time.time()
        mode = opt["equationMode"].lower()
        if mode != "steady":
            raise _todo(f"equationMode {mode!r}", "10")
        if opt["jaxProfileDir"]:
            raise _todo("the profiler hook 'jaxProfileDir'", "13")

        monitor = None
        if opt["printIterations"]:
            mv = (opt["monitorVariables"] if opt["setMonitor"]
                  else ["resrho", "resturb"])
            monitor = _IterMonitor(self, mv)
        tl = float(opt["timeLimit"])
        deadline = (t0 + tl) if tl > 0.0 else None

        self._fmg_start(opt)
        if bool(opt["useNKSolver"]) or bool(opt["useANKSolver"]):
            raise _todo("the ANK/NK solver", "6")
        if str(opt["MGCycle"]).lower() not in ("sg", "none", ""):
            raise _todo(f"multigrid cycle {opt['MGCycle']!r}", "10")
        self.w_list, info = steady.solve_rk(
            self.w_list, self.metrics_list, self.topo, self.cfg,
            self.ref, self.winf,
            cfl=float(opt["CFL"]), n_cycles=int(opt["nCycles"]),
            l2_conv=float(opt["L2Convergence"]),
            l2_conv_rel=float(opt["L2ConvergenceRel"]),
            extras_list=self.extras_list, monitor=monitor,
            smoother=str(opt["smoother"]), deadline=deadline)
        self._fresh_state = False
        self.solve_info = info
        ap.solveFailed = bool(info.failed)
        ap.fatalFail = bool(info.failed)
        if opt["printTiming"]:
            print(f"  solve wall time: {time.time() - t0:.2f} s "
                  f"({info.iterations} iterations, "
                  f"R {info.total_r0:.3e} -> {info.total_r_final:.3e})")

    def _fmg_start(self, opt):
        """Full-multigrid start (reference: solvers.F90:63). With the
        single-grid 'sg' cycle and MGStartLevel -1 (the defaults) there is
        nothing to do; a coarser start level is not ported."""
        lvl_opt = int(opt["MGStartLevel"])
        if lvl_opt == 1 or not getattr(self, "_fresh_state", False):
            return
        if lvl_opt < 0:
            cyc = str(opt["MGCycle"]).strip().lower()
            want = 1 if cyc in ("sg", "", "none", "1") else int(cyc[:-1])
        else:
            want = max(lvl_opt, 1)
        if want >= 2:
            raise _todo("the full-multigrid start", "10")

    def addUserSurface(self, *args, **kwargs):
        raise _todo("user surfaces", "11")

    # ------------------------------------------------------------------
    def _filled_w(self):
        return fill_halos(self.w_list, self.metrics_list, self.topo,
                          self.ref, self.winf)

    def evalFunctions(self, ap: AeroProblem, funcs: dict,
                      evalFuncs: Optional[Sequence[str]] = None,
                      ignoreMissing: bool = True):
        """Reference: pyADflow.evalFunctions:1536 — fills
        funcs['<ap.name>_<func>']."""
        self.setAeroProblem(ap)
        if self.flow_patches:
            raise _todo("flow-through integration (inflow/outflow "
                        "families)", "7")
        if evalFuncs is None:
            evalFuncs = ap.evalFuncs
        wf = self._filled_w()
        f = integrate_forces(wf, self.x_list, self.metrics_list,
                             self.wall_patches, self.ref, self.cfg,
                             extras_list=self.extras_list)
        f.update(wall_sensors(wf, self.metrics_list, self.wall_patches,
                              self.ref, x_list=self.x_list))
        all_funcs = cost_functions(f, self.ref)
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

    def setOption(self, name: str, value):
        self.options = self.options.replace(**{name: value})

    def getOption(self, name: str):
        return self.options[name]


Solver = ADFLOW
