"""Newton-type implicit solvers: ANK (pseudo-transient) and NK (full
Newton), and the switching driver (counterpart of adflow_tpu/solvers/
newton.py; reference NKSolvers.F90 and solveState, solvers.F90:892).

- ANK: backward-Euler pseudo-transient steps with a per-cell CFL-scaled
  diagonal, an SER CFL ramp, a physicality limit on density and energy
  changes and matrix-free GMRES solves (reference ANKStep:3629).
- NK: matrix-free Newton-Krylov with Eisenstat-Walker forcing and a
  backtracking line search (reference NKStep:512).
- The driver: RK startup -> ANK -> NK by relative-residual thresholds.

The Jacobian-vector product is an exact ``torch.func.jvp`` through the one
residual; on the card in float32 it runs through the residual kernels'
``autograd.Function``s (ops/cuda_rans.py, ops/cuda_inviscid.py), whose jvp
evaluates the plain version while the primal launches the kernel. The PC is
the line-implicit preconditioner (solvers/linpc.py) or, with
``ANKGlobalPreconditioner`` / ``NKGlobalPreconditioner`` 'multigrid', the
Galerkin stencil multigrid around it (solvers/amg.py), built outside the
step and lagged.

Each step returns its stats vector (7 entries for ANK, 5 for NK, the JAX
package's layout) as one device tensor, which the driver copies to the host
once, and the number of exact residual evaluations it made. The JAX
package's ``jax.vmap`` over the three merit step sizes is a loop of three
evaluations here.

With ``precision='mixed'`` the f32 phases hand over to an f64
continuation: the same driver re-entered in float64 from the f32 state,
with f64 metrics and free stream (``mixed_data``). It runs the plain
residual, as the kernels are f32 only.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, List, NamedTuple, Optional

import numpy as np
import torch

from adflow_torch.physics.fluxes import spectral_radii
from adflow_torch.physics.residual import (
    MeshTopology, ProblemConfig, fill_halos, residual_list)
from adflow_torch.physics.thermo import IRHO, IRHOE, pressure
from adflow_torch.physics.timestep import viscous_spectral_radii
from adflow_torch.solvers import steady
from adflow_torch.solvers.krylov import gmres
from adflow_torch.utils import trace


# ---------------------------------------------------------------------------
# flat-vector packing of interior states
# ---------------------------------------------------------------------------

class Packer:
    """Pack per-block interior states into one flat vector (the reference's
    PETSc global state vector, setGlobalCellsAndNodes ordering)."""

    def __init__(self, block_dims, nw: int):
        self.block_dims = [tuple(d) for d in block_dims]
        self.nw = nw
        self.sizes = [d[0] * d[1] * d[2] * nw for d in self.block_dims]
        self.offsets = np.concatenate([[0], np.cumsum(self.sizes)]).tolist()
        self.n = int(self.offsets[-1])

    def pack(self, arr_list):
        return torch.cat([a.reshape(-1) for a in arr_list])

    def unpack(self, vec):
        return [vec[self.offsets[i]:self.offsets[i + 1]].reshape(
                    d + (self.nw,))
                for i, d in enumerate(self.block_dims)]

    def pack_w(self, w_list):
        """Interior-only pack of halo-padded states."""
        return torch.cat([w[2:-2, 2:-2, 2:-2].reshape(-1) for w in w_list])

    def unpack_into(self, vec, w_list):
        """Copies of the halo-padded states with the flat vector written
        into their interiors."""
        out = []
        for w, interior in zip(w_list, self.unpack(vec)):
            w = w.clone()
            w[2:-2, 2:-2, 2:-2] = interior
            out.append(w)
        return out


class NewtonFns(NamedTuple):
    res_flat: Callable            # wvec -> rvec
    rad_sum_cells: Callable       # wvec -> (filled w_list, radius sums)
    collect_pc_data: Callable     # (wvec, cfl) -> [LinePCData] per block
    build_pc: Callable            # (wvec, cfl, **kw) -> [PC data] per block
    packer: Packer
    row_scale_vec: Optional[torch.Tensor] = None  # (nw,) turbResScale rows
    # first-order (lumped-dissipation) residual twin for the approximate
    # ANK linearization above ANKSecondOrdSwitchTol (reference: the approx
    # dissipation variants fluxes.F90:3861/4344)
    res_flat_approx: Optional[Callable] = None
    # evaluations of res_flat so far (the exact residual, the one that runs
    # through the residual kernels on the card), under key "res"
    counts: Optional[dict] = None


class StepRecord(NamedTuple):
    """One ANK or NK step of the driver, as the host saw it."""
    kind: str              # "ANK" | "NK"
    cfl: Optional[float]   # the CFL the ANK step ran at; None for NK
    stats: np.ndarray      # the step's stats vector
    res_evals: int         # exact residual evaluations in the step
    krylov_matvecs: int    # GMRES matvecs (one per cycle + iterations)
    seconds: float         # host wall time, PC fetch to stats on the host
    dtype: Optional[torch.dtype] = None   # the state's: float64 in the f64
    #                        continuation of precision='mixed'


def _pc_apply_block(data, v):
    """Apply one block's PC data, line or multigrid, by its type."""
    from adflow_torch.solvers.amg import AMGPCData, amg_pc_apply
    from adflow_torch.solvers.linpc import line_pc_apply

    if isinstance(data, AMGPCData):
        return amg_pc_apply(data, v)
    return line_pc_apply(data, v)


def pc_apply_vec(pc_data, packer: Packer, v):
    """M^-1 v on the packed vector from per-block lagged PC data."""
    vb = packer.unpack(v)
    return packer.pack([_pc_apply_block(d, vv)
                        for d, vv in zip(pc_data, vb)])


def build_newton_fns(template_w_list, metrics_list, topo: MeshTopology,
                     cfg: ProblemConfig, ref, winf, extras_list=None,
                     approx_sigma: float = 6.0) -> NewtonFns:
    packer = Packer([w[2:-2, 2:-2, 2:-2].shape[:3] for w in template_w_list],
                    template_w_list[0].shape[-1])
    # free-stream-filled templates: corner halo cells that no BC subface or
    # connection writes must still hold physical states
    template = [winf.to(w.dtype).expand(w.shape).clone()
                for w in template_w_list]
    counts = {"res": 0}

    def res_flat(wvec):
        counts["res"] += 1
        w_list = packer.unpack_into(wvec, template)
        r_list = residual_list(w_list, metrics_list, topo, cfg, ref, winf,
                               extras_list)
        return packer.pack(r_list)

    # first-order twin: upwind drops to the first-order limiter; central
    # schemes lump the 4th difference into a constant 2nd-difference
    # coefficient vis2 + sigma*vis4 (reference
    # inviscidDissFluxScalarApprox). Neither reaches a kernel: upwind never
    # does, and the lumped twin runs on the plain path
    if cfg.discretization.startswith("upwind"):
        cfg_approx = dataclasses.replace(cfg, limiter="first order")
    else:
        cfg_approx = dataclasses.replace(
            cfg, coarse_level=True, use_kernels=False,
            vis2=cfg.vis2 + approx_sigma * cfg.vis4)

    def res_flat_approx(wvec):
        w_list = packer.unpack_into(wvec, template)
        r_list = residual_list(w_list, metrics_list, topo, cfg_approx, ref,
                               winf, extras_list)
        return packer.pack(r_list)

    def rad_sum_cells(wvec):
        """Per-block (ni,nj,nk) sum of convective (+viscous) spectral radii
        — V/dt per cell is rad_sum / CFL (timeStep_block analogue)."""
        w_list = packer.unpack_into(wvec, template)
        w_list = fill_halos(w_list, metrics_list, topo, ref, winf)
        outs = []
        for w, m in zip(w_list, metrics_list):
            p = torch.clamp(pressure(w), min=1e-10)
            rI, rJ, rK = spectral_radii(w, p, m, cfg.ls_precon_mach)
            rs = (rI + rJ + rK)[1:-1, 1:-1, 1:-1]
            if cfg.viscous:
                rv = viscous_spectral_radii(w, m, cfg, ref)
                rs = rs + 4.0 * (rv[0] + rv[1] + rv[2])
            outs.append(rs)
        return w_list, outs

    def collect_pc_data(wvec, cfl, axes=(1, 0, 2), kappa=0.25):
        from adflow_torch.solvers.linpc import build_line_pc
        w_list, rs_list = rad_sum_cells(wvec)
        return [build_line_pc(w, m, cfg, ref, dtinv=rs / cfl, axes=axes,
                              kappa=kappa)
                for w, m, rs in zip(w_list, metrics_list, rs_list)]

    def build_pc(wvec, cfl, axes=(1, 0, 2), kappa=1.0,
                 pc_kind: str = "line", amg_levels: int = 2,
                 amg_nsmooth: int = 1):
        """Per-block PC data for (V/dt + dR/dw): line-implicit
        (solvers/linpc.py) or the Galerkin stencil multigrid
        (solvers/amg.py, *GlobalPreconditioner='multigrid'), built outside
        the steps and lagged (NKJacobianLag)."""
        if pc_kind == "multigrid":
            from adflow_torch.solvers.amg import build_amg_pc
            w_list, rs_list = rad_sum_cells(wvec)
            return [build_amg_pc(w, m, cfg, ref, dtinv=rs / cfl,
                                 levels=amg_levels, n_smooth=amg_nsmooth,
                                 axes=axes, kappa=kappa)
                    for w, m, rs in zip(w_list, metrics_list, rs_list)]
        return collect_pc_data(wvec, cfl, axes, kappa)

    w0 = template_w_list[0]
    return NewtonFns(res_flat=res_flat, rad_sum_cells=rad_sum_cells,
                     collect_pc_data=collect_pc_data, build_pc=build_pc,
                     packer=packer,
                     row_scale_vec=cfg.row_scale(w0.dtype, w0.device),
                     res_flat_approx=res_flat_approx, counts=counts)


# ---------------------------------------------------------------------------
# physicality limiting (reference: physicalityCheckANK, NKSolvers.F90:3013)
# ---------------------------------------------------------------------------

def physicality_alpha(wvec, dwvec, packer: Packer, rel_tol: float = 0.2,
                      turb_rel_tol: float = 0.99):
    """Global under-relaxation so no cell's rho or rhoE changes by more than
    rel_tol (turbulence by turb_rel_tol). A 0-dim tensor on the device."""
    alpha = torch.ones((), dtype=wvec.dtype, device=wvec.device)
    for w, d in zip(packer.unpack(wvec), packer.unpack(dwvec)):
        for idx, tol in ((IRHO, rel_tol), (IRHOE, rel_tol)):
            rel = torch.abs(d[..., idx]) / torch.clamp(
                torch.abs(w[..., idx]), min=1e-12)
            alpha = torch.minimum(
                alpha, tol / torch.clamp(torch.max(rel), min=tol))
        if packer.nw > 5:
            # turbulence: prevent the update driving nuTilde far negative
            neg = -d[..., 5] / torch.clamp(torch.abs(w[..., 5]), min=1e-12)
            alpha = torch.minimum(alpha, turb_rel_tol / torch.clamp(
                torch.max(neg), min=turb_rel_tol))
    return alpha


# ---------------------------------------------------------------------------
# ANK step
# ---------------------------------------------------------------------------

def _pc_params(opts):
    axes = opts["linePCAxes"]
    if axes == "auto" or axes is None:
        axes = (1, 0, 2)
    else:
        axes = tuple(axes)
    return axes, float(opts["linePCKappa"])


def _pc_choice(opts, prefix: str) -> dict:
    """PC-family kwargs for build_pc (reference: pyADflow.py:5805-5831)."""
    if prefix == "ANK":
        kind = str(opts["ANKGlobalPreconditioner"]).lower()
        levels = int(opts["ANKAMGLevels"])
        nsmooth = int(opts["ANKAMGNSmooth"])
    else:
        kind = str(opts["NKGlobalPreconditioner"]).lower()
        levels = int(opts["NKAMGLevels"])
        nsmooth = int(opts["NKAMGNSmooth"])
    return dict(
        pc_kind=("multigrid" if kind == "multigrid" else "line"),
        amg_levels=levels, amg_nsmooth=nsmooth)


class StepResult(NamedTuple):
    w: torch.Tensor        # the new flat state
    stats: torch.Tensor    # the stats vector, on the device
    res_evals: int         # exact residual evaluations in the step
    krylov_matvecs: int    # matvecs of the step's main GMRES solve


def _scalar(x, like):
    return torch.as_tensor(x, dtype=like.dtype, device=like.device)


def make_ank_step(fns: NewtonFns, opts, segregated: bool = False,
                  approx: bool = False):
    """One ANK step. ``segregated=False``: the fully coupled mean-flow +
    turbulence Newton system. ``segregated=True``: the Krylov system covers
    the mean-flow rows only (turbulence frozen), then the turbulence
    advances at the new mean flow by ANKNSubiterTurb implicit line-solve
    subiterations (ANKUseTurbDADI=True) or a small turbulence-rows Krylov
    solve (False, the reference's turbKSP, NKSolvers.F90:3337).

    ``approx=True``: the Krylov matvec linearizes the first-order
    (lumped-dissipation) residual twin while the right-hand side and merits
    stay exact — the reference's approximate ANK formulation used while
    totalR > ANK_secondOrdSwitchTol*totalR0."""
    m = int(opts["ANKSubspaceSize"])
    if m <= 0:
        m = 50
    # ANKMaxIter (reference ank_maxIter): cap on Krylov iterations per step
    m = min(m, max(int(opts["ANKMaxIter"]), 1))
    turb_cfl_scale = float(opts["ANKTurbCFLScale"])
    lintol = float(opts["ANKLinearSolveTol"])
    phys_tol = float(opts["ANKPhysicalLSTol"])
    phys_tol_turb = float(opts["ANKPhysicalLSTolTurb"])
    step_factor = float(opts["ANKStepFactor"])
    step_min = float(opts["ANKStepMin"])
    use_turb_dadi = bool(opts["ANKUseTurbDADI"])
    n_sub_turb = max(int(opts["ANKNSubiterTurb"]),
                     int(opts["nSubiterTurb"]), 1)
    nw = fns.packer.nw
    seg = segregated and nw > 5
    res_lin = (fns.res_flat_approx if approx and fns.res_flat_approx
               is not None else fns.res_flat)

    def ank_step(wvec, cfl, pc_data) -> StepResult:
        evals0 = fns.counts["res"]
        r = fns.res_flat(wvec)
        rnorm = torch.linalg.norm(r)
        _, rs_list = fns.rad_sum_cells(wvec)
        # the pseudo-time diagonal carries the residual's turbulence row
        # scale, so (D + J) dw = -R is an exact row scaling of the unscaled
        # backward-Euler system; ANKTurbCFLScale marches turbulence rows at
        # cfl * scale
        chan = torch.ones((nw,), dtype=wvec.dtype, device=wvec.device)
        if fns.row_scale_vec is not None:
            chan = chan * fns.row_scale_vec
        if turb_cfl_scale != 1.0 and nw > 5:
            chan = torch.cat([chan[:5], chan[5:] / turb_cfl_scale])
        diag = fns.packer.pack([(rs / cfl)[..., None].expand(rs.shape + (nw,))
                                * chan for rs in rs_list])

        if seg:
            mk = torch.cat([
                (torch.arange(nw, device=wvec.device) < 5).to(wvec.dtype)
                .expand(tuple(d) + (nw,)).reshape(-1)
                for d in fns.packer.block_dims])

            def matvec(v):
                _, jv = torch.func.jvp(res_lin, (wvec,), (mk * v,))
                return diag * v + mk * jv

            def precond(v):
                return (mk * pc_apply_vec(pc_data, fns.packer, mk * v)
                        + (1.0 - mk) * v)

            rhs = -(mk * r)
        else:
            def matvec(v):
                _, jv = torch.func.jvp(res_lin, (wvec,), (v,))
                return diag * v + jv

            def precond(v):
                return pc_apply_vec(pc_data, fns.packer, v)

            rhs = -r

        sol = gmres(matvec, rhs, m=m, restarts=2, tol=lintol,
                    precond=precond)
        alpha0 = physicality_alpha(wvec, sol.x, fns.packer, phys_tol,
                                   phys_tol_turb) * step_factor

        # backtracking on the unsteady residual ||D a dw + R(w + a dw)||,
        # the merit of pseudo-transient marching (reference:
        # computeUnsteadyResANK, NKSolvers.F90:2614)
        alphas = torch.stack([alpha0, 0.5 * alpha0, 0.25 * alpha0])
        merits = torch.stack([
            torch.linalg.norm(diag * (a * sol.x)
                              + fns.res_flat(wvec + a * sol.x))
            for a in alphas])
        best = torch.argmin(merits)
        # ANKStepMin: never march below the minimum step; the driver sees
        # alpha <= step_min and cuts the CFL back
        alpha = torch.clamp(alphas[best], min=step_min)
        mnew = merits[best]
        # each index by the device's argmin reads it on the host
        trace.host_sync(2)
        wnew = wvec + alpha * sol.x
        if seg:
            if use_turb_dadi:
                # turbulence subiterations at the new mean flow: implicit
                # line-solve updates via the PC's turbulence tridiagonal
                # (the DD-ADI analogue, turbAPI.F90:4 turbSolveDDADI)
                for _ in range(n_sub_turb):
                    rt = (1.0 - mk) * fns.res_flat(wnew)
                    dwt = (1.0 - mk) * pc_apply_vec(pc_data, fns.packer,
                                                    -rt)
                    # turbulence physicality (physicalityCheckANK turb
                    # branch, NKSolvers.F90:3212)
                    rel = torch.abs(dwt) / torch.clamp(torch.abs(wnew),
                                                       min=1e-12)
                    at = torch.clamp(phys_tol_turb / torch.clamp(
                        torch.max(rel), min=1e-30), max=1.0)
                    wnew = wnew + at * dwt
            else:
                # turbKSP (ANKTurbSolveKSP, NKSolvers.F90:3337): backward-
                # Euler Newton solve on the turbulence rows at the frozen
                # new mean flow
                wcur = wnew
                for _ in range(n_sub_turb):
                    rt = (1.0 - mk) * fns.res_flat(wcur)

                    def tmatvec(v, wcur=wcur):
                        _, jv = torch.func.jvp(res_lin, (wcur,),
                                               ((1.0 - mk) * v,))
                        return diag * v + (1.0 - mk) * jv

                    def tprecond(v):
                        return ((1.0 - mk) * pc_apply_vec(
                            pc_data, fns.packer, (1.0 - mk) * v)
                            + mk * v)

                    tsol = gmres(tmatvec, -rt, m=min(m, 20), restarts=1,
                                 tol=lintol, precond=tprecond)
                    dwt = (1.0 - mk) * tsol.x
                    rel = torch.abs(dwt) / torch.clamp(torch.abs(wcur),
                                                       min=1e-12)
                    at = torch.clamp(phys_tol_turb / torch.clamp(
                        torch.max(rel), min=1e-30), max=1.0)
                    wcur = wcur + at * dwt
                wnew = wcur
        rnew = torch.linalg.norm(fns.res_flat(wnew))
        # alpha0 (the physicality-limited step before merit backtracking)
        # is the reference's lambda for the ANKStepMin/ANKConstCFLStep CFL
        # gates; all scalars in one tensor, one host copy for the driver
        stats = torch.stack([
            rnorm, rnew, alpha, alpha0, _scalar(float(sol.iters), wvec),
            _scalar(sol.res_norm / max(sol.b_norm, 1e-30), wvec),
            mnew / torch.clamp(rnorm, min=1e-30)])
        return StepResult(wnew, stats, fns.counts["res"] - evals0,
                          sol.matvecs)

    return ank_step


# ---------------------------------------------------------------------------
# NK step with Eisenstat-Walker + backtracking line search
# ---------------------------------------------------------------------------

def make_nk_step(fns: NewtonFns, opts):
    m = int(opts["NKSubspaceSize"])
    ls_kind = str(opts["NKLS"]).lower()
    # NKFixedStep (reference NK_fixedStep, NKSolvers.F90:973): the step
    # taken with NKLS='none' (physicality still caps it)
    fixed_step = float(opts["NKFixedStep"])

    def nk_step(wvec, eta, pc_data) -> StepResult:
        evals0 = fns.counts["res"]
        r = fns.res_flat(wvec)
        rnorm = torch.linalg.norm(r)

        def matvec(v):
            _, jv = torch.func.jvp(fns.res_flat, (wvec,), (v,))
            return jv

        # lagged PC built at a large pseudo-CFL regularization
        def precond(v):
            return pc_apply_vec(pc_data, fns.packer, v)

        sol = gmres(matvec, -r, m=m, restarts=2, tol=float(eta),
                    precond=precond)
        alpha0 = physicality_alpha(wvec, sol.x, fns.packer)

        def merit(a):
            return torch.linalg.norm(fns.res_flat(wvec + a * sol.x))

        if ls_kind == "none":
            alpha = torch.clamp(alpha0, max=fixed_step)
        else:
            # backtracking: try alpha0, then halve while the merit is above
            # the current residual and the halved step is better (a fixed
            # unroll of 4, every merit evaluated, as in the JAX package)
            alpha, fa = alpha0, merit(alpha0)
            for _ in range(4):
                a2 = 0.5 * alpha
                fa2 = merit(a2)
                take = (fa > rnorm) & (fa2 < fa)
                alpha = torch.where(take, a2, alpha)
                fa = torch.where(take, fa2, fa)
        wnew = wvec + alpha * sol.x
        rnew = torch.linalg.norm(fns.res_flat(wnew))
        stats = torch.stack([
            rnorm, rnew, alpha, _scalar(float(sol.iters), wvec),
            _scalar(sol.res_norm / max(sol.b_norm, 1e-30), wvec)])
        return StepResult(wnew, stats, fns.counts["res"] - evals0,
                          sol.matvecs)

    return nk_step


class _LaggedPC:
    """Jacobian/PC lagging (reference: NKJacobianLag / ANKJacobianLag /
    ANKPCUpdateTol, NKSolvers.F90:372,559): rebuild the per-block PC data
    only every ``lag`` iterations, or when the residual dropped past
    ``update_tol`` x the build-time residual, or when the CFL moved more
    than 4x from the build-time CFL."""

    def __init__(self, fns: NewtonFns, opts, prefix: str, lag_opt: str):
        axes, kappa = _pc_params(opts)
        kw = _pc_choice(opts, prefix)
        self._build = lambda w, c: fns.build_pc(w, c, axes=axes,
                                                kappa=kappa, **kw)
        self.lag = max(int(opts[lag_opt]), 1)
        self.update_tol = float(opts["ANKPCUpdateTol"])
        self.data = None
        self._it = self._r = self._cfl = None

    def get(self, it, wvec, rnorm, cfl):
        stale = (self.data is None or (it - self._it) >= self.lag
                 or rnorm <= self.update_tol * self._r
                 or not (0.25 <= cfl / self._cfl <= 4.0))
        if stale:
            with trace.span("newton.pc_build"):
                self.data = self._build(wvec, cfl)
            self._it, self._r, self._cfl = it, rnorm, cfl
        return self.data


# ---------------------------------------------------------------------------
# the switching driver (reference: solveState, solvers.F90:892)
# ---------------------------------------------------------------------------

def solve_newton_driver(w_list, metrics_list, topo, cfg, ref, winf, opts,
                        extras_list=None, monitor=None,
                        deadline: Optional[float] = None,
                        signal_check=None, mixed_data=None):
    """RK startup, ANK phase and NK phase; returns (w_list, SolveInfo).

    ``SolveInfo.steps`` holds a ``StepRecord`` per ANK/NK step. Besides the
    steps, the driver evaluates the exact residual twice at its start (the
    free-stream and the starting norms).

    ``mixed_data``: (metrics64_list, winf64, extras64_list), present for
    precision='mixed'. With NK on, the f32 ANK phase then hands over once
    the residual is 1e-2 of the free-stream one, and the NK phase becomes
    the f64 continuation: this driver in float64 from the f32 state (the
    metrics recomputed from f64 node coordinates, not upcast: f32 face
    areas break the telescoping flux sum at ~1e-7 relative).

    ``signal_check``: ``SignalMonitor.check`` (utils/signals.py), polled
    before each ANK or NK step and by the startup smoother, with a provider
    of the current iterate; 'stop' ends the solve. The poll reads a flag on
    the host and adds no device sync."""
    fns = build_newton_fns(w_list, metrics_list, topo, cfg, ref, winf,
                           extras_list,
                           approx_sigma=float(
                               opts["dissipationLumpingParameter"]))
    wvec = fns.packer.pack_w(w_list)
    steps: List[StepRecord] = []

    def _mon(it, rnorm, rt, cfl=None, linres=None, itertype=""):
        if monitor is None:
            return
        kw = dict(cfl=cfl, linres=linres, itertype=itertype)
        if getattr(monitor, "needs_state", False):
            kw["w_list"] = fns.packer.unpack_into(wvec, w_list)
        monitor(it, rnorm, rt, **kw)

    def _record(kind, cfl, res: StepResult, t0):
        st = res.stats.double().cpu().numpy()   # ONE device->host copy
        trace.host_sync()
        steps.append(StepRecord(kind, cfl, st, res.res_evals,
                                res.krylov_matvecs,
                                time.perf_counter() - t0, res.w.dtype))
        return res.w, st

    # convergence is measured against the free-stream residual norm
    # (reference: getFreeStreamResidual -> totalR0, solvers.F90:972)
    winf_vec = fns.packer.pack(
        [winf.expand(tuple(d) + (fns.packer.nw,))
         for d in fns.packer.block_dims])
    r_free = float(torch.linalg.norm(fns.res_flat(winf_vec)))
    rnorm = float(torch.linalg.norm(fns.res_flat(wvec)))
    trace.host_sync(2)
    r0 = max(r_free, 1e-30)
    l2conv = float(opts["L2Convergence"]) * r0
    l2abs = float(opts["L2ConvergenceRel"])
    target = max(l2conv, l2abs)
    n_cycles = int(opts["nCycles"])

    use_ank = bool(opts["useANKSolver"])
    use_nk = bool(opts["useNKSolver"])
    ank_switch = float(opts["ANKSwitchTol"]) * r0
    nk_switch = float(opts["NKSwitchTol"]) * r0

    hist = []
    it = 0
    failed = False

    # ---- startup smoother until the ANK window (reference FMG/MG phase) --
    if (not use_ank or rnorm > ank_switch) and rnorm > target:
        rk_target = ank_switch if use_ank else (nk_switch if use_nk
                                                else target)
        w_list = fns.packer.unpack_into(wvec, w_list)
        w_list, info = steady.solve_rk(
            w_list, metrics_list, topo, cfg, ref, winf,
            cfl=float(opts["CFL"]), n_cycles=n_cycles,
            l2_conv=rk_target / max(r0, 1e-30),
            extras_list=extras_list, monitor=monitor, total_r0=r0,
            smoother=str(opts["smoother"]), deadline=deadline,
            signal_check=signal_check)
        wvec = fns.packer.pack_w(w_list)
        hist.append(info.history)
        it += info.iterations
        rnorm = info.total_r_final
        failed = info.failed

    # ---- ANK phase ----
    if use_ank and not failed and rnorm > target:
        # segregated-vs-coupled turbulence (ANKCoupledSwitchTol) and the
        # first-order linearization window (ANKSecondOrdSwitchTol); the
        # defaults (1e3) couple and go second order immediately
        coupled_switch = float(opts["ANKCoupledSwitchTol"]) * r0
        second_ord_switch = float(opts["ANKSecondOrdSwitchTol"]) * r0
        _steps = {}

        def ank_step_for(rn):
            seg = (rn > coupled_switch and fns.packer.nw > 5)
            approx = rn > second_ord_switch
            key = (seg, approx)
            if key not in _steps:
                _steps[key] = make_ank_step(fns, opts, segregated=seg,
                                            approx=approx)
            return _steps[key]
        cfl = float(opts["ANKCFL0"])
        cfl_min = float(opts["ANKCFLMin"])
        cfl_limit = float(opts["ANKCFLLimit"])
        cfl_factor = float(opts["ANKCFLFactor"])
        cfl_exp = float(opts["ANKCFLExponent"])
        cutback = float(opts["ANKCFLCutback"])
        lin_res_max = float(opts["ANKLinResMax"])
        unsteady_ls_tol = float(opts["ANKUnsteadyLSTol"])
        # SER anchor = the free-stream residual scale r0
        r_ank0 = max(rnorm, r0)
        n_reject = 0
        # learned CFL ceiling: when the linear solver fails at CFL X, cap
        # subsequent growth near X and release the cap slowly
        cfl_cap = cfl_limit
        # best-state checkpoint: a blow-up restores here
        best_w, best_r = wvec, rnorm
        lagged = _LaggedPC(fns, opts, "ANK", "ANKJacobianLag")
        while it < n_cycles and rnorm > target and not failed:
            if use_nk and rnorm <= nk_switch:
                break
            # mixed-precision handover: the f32 ANK floors at its own
            # evaluation noise, and the f64 continuation (itself a
            # pseudo-transient continuation) takes over once a transient
            # has settled, at 1e-2 of the free-stream residual
            if mixed_data is not None and use_nk and rnorm <= 1e-2 * r0:
                wvec = best_w if best_r < rnorm else wvec
                rnorm = min(rnorm, best_r)
                break
            if deadline is not None and time.time() >= deadline:
                break
            if signal_check is not None and signal_check(
                    lambda: fns.packer.unpack_into(wvec, w_list)) == "stop":
                break
            with trace.span("newton.step", fns.counts):
                t0 = time.perf_counter()
                res = ank_step_for(rnorm)(wvec, cfl,
                                          lagged.get(it, wvec, rnorm, cfl))
                wnew, st = _record("ANK", cfl, res, t0)
            (_, rnew_f, _alpha_f, alpha0_f, _kiters_f, linres_f,
             umerit_f) = (float(v) for v in st)
            it += 1
            # accept on the unsteady-residual merit (time marching)
            bad = (not np.isfinite(rnew_f)
                   or umerit_f > unsteady_ls_tol
                   or rnew_f > 100.0 * best_r)
            if bad:
                cfl_cap = max(cfl * cutback, cfl_min)
                cfl = max(cfl * cutback, cfl_min)
                n_reject += 1
                if rnew_f > 1e3 * best_r or not np.isfinite(rnew_f):
                    wvec = best_w          # restore checkpoint
                if n_reject > 25:
                    failed = True
                continue
            n_reject = 0
            wvec = wnew
            rnorm = rnew_f
            if rnorm < best_r:
                best_w, best_r = wvec, rnorm
            elif rnorm > 5.0 * best_r:
                # sustained steady-residual growth with accepted unsteady
                # steps: restore the best state and learn a harder ceiling
                wvec = best_w
                rnorm = best_r
                cfl_cap = max(cfl * cutback, cfl_min)
                cfl = max(cfl * cutback, cfl_min)
            hist.append(np.array([[rnorm, 0.0]]))
            _mon(it, rnorm, 0.0, cfl=cfl, linres=linres_f, itertype="ANK")
            # CFL controller (reference: ANKLinResMax gating + SER ramp),
            # gated on the physicality step alpha0 (the reference's lambda)
            alpha_f = alpha0_f
            if alpha_f <= float(opts["ANKStepMin"]) + 1e-12:
                cfl_cap = max(cfl * cutback, cfl_min)
                cfl = max(cfl * cutback, cfl_min)
            elif alpha_f < float(opts["ANKConstCFLStep"]):
                pass   # hold the CFL constant this iteration
            elif linres_f > lin_res_max:
                cfl_cap = max(cfl * cutback, cfl_min)
                cfl = max(cfl * cutback, cfl_min)
            elif linres_f <= lin_res_max:
                cfl_cap = min(cfl_cap * 1.2, cfl_limit)
                cfl = min(
                    float(opts["ANKCFL0"]) * (r_ank0 / max(rnorm, 1e-30))
                    ** cfl_exp,
                    cfl * cfl_factor, cfl_cap, cfl_limit)
                cfl = max(cfl, cfl_min)
            else:
                cfl_cap = min(cfl_cap * 1.05, cfl_limit)

    # ---- f64 continuation (precision='mixed') ----
    # deadline guard, as in the JAX package (whose f64 phase starts with
    # compiles that cannot be interrupted): only with a minute left
    if (use_nk and not failed and rnorm > target
            and mixed_data is not None
            and (deadline is None or time.time() < deadline - 60.0)):
        # the f32 phases hand over once the transient has settled; the
        # endgame re-enters this driver in float64 (f64 ANK re-ramps, f64
        # NK finishes to the deep target), warm-started from the f32 state
        metrics64, winf64, extras64 = mixed_data
        w_list64 = [w.to(torch.float64)
                    for w in fns.packer.unpack_into(wvec, w_list)]
        w_list64, info64 = solve_newton_driver(
            w_list64, metrics64, topo, cfg, ref, winf64,
            opts, extras_list=extras64, monitor=monitor, deadline=deadline,
            signal_check=signal_check, mixed_data=None)
        wvec = fns.packer.pack_w([w.to(wvec.dtype) for w in w_list64])
        it += info64.iterations
        rnorm = info64.total_r_final
        failed = info64.failed
        if len(info64.history):
            hist.append(info64.history)
        steps.extend(info64.steps)

    # ---- NK phase ----
    elif use_nk and not failed and rnorm > target:
        nk_step = make_nk_step(fns, opts)
        eta_max = float(opts["NKLinearSolveTol"])
        use_ew = bool(opts["NKUseEW"])
        ew_exp = float(opts["NKEWRTolExponent"])
        eta = eta_max
        lagged = _LaggedPC(fns, opts, "NK", "NKJacobianLag")
        while it < n_cycles and rnorm > target and not failed:
            if deadline is not None and time.time() >= deadline:
                break
            if signal_check is not None and signal_check(
                    lambda: fns.packer.unpack_into(wvec, w_list)) == "stop":
                break
            with trace.span("newton.step", fns.counts):
                t0 = time.perf_counter()
                res = nk_step(wvec, eta, lagged.get(it, wvec, rnorm, 1e6))
                wnew, st = _record("NK", None, res, t0)
            rnew_f = float(st[1])
            if not np.isfinite(rnew_f):
                failed = True
                break
            wvec = wnew
            r_prev = rnorm
            rnorm = rnew_f
            it += 1
            hist.append(np.array([[rnorm, 0.0]]))
            _mon(it, rnorm, 0.0, linres=float(st[4]), itertype="NK")
            if use_ew:
                # Eisenstat-Walker choice 2 (reference getEWTol:1606)
                eta = min(eta_max,
                          0.9 * (rnorm / max(r_prev, 1e-30)) ** ew_exp)
                eta = max(eta, 1e-8)

    w_list = fns.packer.unpack_into(wvec, w_list)
    hist_np = (np.concatenate(hist) if hist else np.zeros((0, 2)))
    # maxL2DeviationFactor (reference solvers.F90:1912): out of budget but
    # within factor x target still counts as converged
    dev = float(opts["maxL2DeviationFactor"])
    near = (it >= n_cycles and np.isfinite(rnorm)
            and rnorm <= dev * target)
    info = steady.SolveInfo(
        converged=bool(rnorm <= target or near), failed=bool(failed),
        iterations=it, total_r0=r0, total_r_final=float(rnorm),
        history=hist_np, steps=tuple(steps))
    return w_list, info
