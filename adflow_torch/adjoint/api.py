"""The discrete adjoint through the one residual (counterpart of
adflow_tpu/adjoint/api.py; reference: the adjoint tree of ADflow and
adjointAPI.F90:661 solveAdjoint).

- forward products: ``torch.func.jvp`` of ``res``;
- reverse products: ``torch.func.vjp`` of ``res``, built once per adjoint
  solve and called once per GMRES iteration;
- the adjoint solve: matrix-free GMRES on dR/dw^T psi = dI/dw with the
  transposed block line-implicit preconditioner, or with
  ``adjointGlobalPreconditioner: 'multigrid'`` the transposed Galerkin
  stencil multigrid (solvers/amg.py).

The residual and the functions are traced as R(w, x, params) and
I(w, x, params), with params the design variables {alpha, beta, mach, T,
P, xref[, reynolds]} (degrees, SI) as 0-d tensors and x every block's node
coordinates, so the totals with respect to the flow conditions and the
shape come from the same two vjps: dI/d* = dI/d*|direct - psi^T dR/d*.

On the card in float32 the residual's forward runs the kernels K1 and K2
(ops/cuda_rans.py, ops/cuda_inviscid.py); their backward runs the plain
version, as the JAX package's ``custom_jvp`` does. The traced reference
state makes ``mu_inf`` and ``t_inf_dim`` tensors, which K1 takes as inputs
of their own so that their derivatives are kept.

The wall distance is frozen with respect to x, as in the JAX package.

With grid motion, the rigid-motion face velocities are rebuilt from the
design variables rotRate (rad/s over a_inf, as the primal attaches it),
rotCenter and machGrid, as the JAX package rebuilds them.

With SST the traced free stream carries k_inf and omega_inf rebuilt from
mach and mu_inf as ``make_reference_state`` builds them. The JAX
package's ``traced_winf`` appends nu_tilde_inf and 1.0 there instead, so
its adjoint linearizes a residual whose far-field ghosts differ from the
one its primal solved; the port linearizes the primal's residual.

On an overset mesh the residual goes through the fringe interpolation
(``apply_overset``, out of place) and the iblank mask, and the functions
take the iblank masks, the overlap weights, the zipper's gap triangles and
the cp targets, as ``evalFunctions`` does; each user integration surface
adds its functions. The tables are those of the solver when the functions
are built: a geometry update drops them.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, NamedTuple

import numpy as np
import torch

from adflow_torch.core.refstate import GAMMA, ReferenceState
from adflow_torch.geom.metrics import add_grid_motion, compute_metrics_conn
from adflow_torch.physics.residual import fill_halos, residual_list
from adflow_torch.physics.surface import cost_functions, integrate_forces
from adflow_torch.physics.usersurf import integrate_user_surface
from adflow_torch.solvers.krylov import GmresResult, gmres
from adflow_torch.utils import trace

# The PC's pseudo-CFL: the same large regularization NK uses (the JAX
# package's _transposed_line_pc and solveDirectForRHS).
PC_CFL = 1e6


def traced_reference_state(base: ReferenceState, params) -> ReferenceState:
    """The reference state with the flow-condition fields rebuilt as
    tensors of ``params``, so that derivatives with respect to alpha, beta,
    mach, reynolds, T, P and xref reach the BCs, the viscosity and the
    force nondimensionalization."""
    alpha = params["alpha"] * (math.pi / 180.0)
    beta = params["beta"] * (math.pi / 180.0)
    mach = params["mach"]
    ca, sa = torch.cos(alpha), torch.sin(alpha)
    cb, sb = torch.cos(beta), torch.sin(beta)
    if base.lift_index == 2:
        vel_dir = torch.stack([ca * cb, sa * cb, -sb])
        lift_dir = torch.stack([-sa, ca, torch.zeros_like(sa)])
    else:
        vel_dir = torch.stack([ca * cb, -sb, sa * cb])
        lift_dir = torch.stack([-sa, torch.zeros_like(sa), ca])
    # mu_inf' = mach * L_re / Re: the Mach and Reynolds chains
    re_over_l = (base.mu_inf / base.mach if base.mach > 0 and base.mu_inf > 0
                 else 0.0)
    mu_inf = mach * re_over_l
    extra = {}
    if "reynolds" in params and base.reynolds > 0:
        mu_inf = mu_inf * (base.reynolds / params["reynolds"])
    if "T" in params:
        # the dimensional T_inf drives the Sutherland ratio S/T_inf
        extra["t_inf_dim"] = params["T"]
    if "P" in params:
        # reaches the dimensional cost functions through p_ref_dim = gamma P
        extra["p_ref_dim"] = GAMMA * params["P"]
    if "xref" in params:
        extra["moment_ref"] = params["xref"]
    if base.n_turb == 2:
        # the SST free stream of make_reference_state: k = 1.5 (I M)^2,
        # omega = k / (mu_inf eddyVisInfRatio), the ratio recovered from
        # the base state
        k_inf = 1.5 * (1e-3 * mach) ** 2
        extra["k_inf"] = k_inf
        extra["omega_inf"] = (
            k_inf / (mu_inf * (base.k_inf / (base.mu_inf * base.omega_inf)))
            if base.mu_inf > 0 else base.omega_inf)
    return dataclasses.replace(
        base, u_inf=mach * vel_dir, mu_inf=mu_inf,
        nu_tilde_inf=3.0 * mu_inf, vel_dir=vel_dir, drag_dir=vel_dir,
        lift_dir=lift_dir, q_inf=0.5 * mach ** 2, **extra)


def traced_winf(ref: ReferenceState):
    """The conservative free stream of a traced reference state: SA's
    nuTilde, or SST's k and omega, as ``ReferenceState.winf``."""
    vel = ref.u_inf
    rho_e = ref.p_inf / (GAMMA - 1.0) + 0.5 * torch.sum(vel * vel)
    parts = [torch.ones(1, dtype=vel.dtype, device=vel.device), vel,
             rho_e[None]]
    turb = {1: ("nu_tilde_inf",), 2: ("k_inf", "omega_inf")}.get(
        ref.n_turb, ())
    parts += [torch.as_tensor(getattr(ref, f), dtype=vel.dtype,
                              device=vel.device).reshape(1) for f in turb]
    return torch.cat(parts)


class AdjointFns(NamedTuple):
    res: Callable        # (wvec, xvec, params) -> rvec
    funcs: Callable      # (wvec, xvec, params) -> {name: scalar}
    pack_x: Callable
    unpack_x: Callable


def build_adjoint_fns(solver) -> AdjointFns:
    """Bind the traced residual and function pipeline to a solver (its
    topology, options, wall distance and reference state at this call)."""
    packer = solver._newton_packer()
    topo, cfg, base_ref = solver.topo, solver.cfg, solver.ref
    extras_list = solver.extras_list   # frozen wall distance
    x_shapes = [tuple(x.shape) for x in solver.x_list]
    x_offsets = np.concatenate(
        [[0], np.cumsum([math.prod(s) for s in x_shapes])]).tolist()
    wall_patches = solver.wall_patches
    surface_kw = dict(
        iblank_list=[bs.iblank for bs in topo.blocks],
        patch_weights=solver.wall_patch_weights,
        cp_targets=solver._cp_targets, zipper=solver.zipper_gaps)
    user_surfaces = list(solver._user_surfaces)
    dtype = solver.dtype
    mesh_blocks = solver.mesh.blocks
    pad_shapes = [tuple(d + 4 for d in bs.dims) + (packer.nw,)
                  for bs in topo.blocks]

    def pack_x(x_list):
        return torch.cat([x.reshape(-1) for x in x_list])

    def unpack_x(xvec):
        return [xvec[x_offsets[i]:x_offsets[i + 1]].reshape(s)
                for i, s in enumerate(x_shapes)]

    def _prep(wvec, xvec, params):
        ref = traced_reference_state(base_ref, params)
        winf = traced_winf(ref).to(dtype)
        x_list = unpack_x(xvec)
        metrics_list = compute_metrics_conn(mesh_blocks, x_list)
        if "rotRate" in params or "machGrid" in params:
            # the primal's rigid grid motion (setAeroProblem) as functions
            # of the design variables, rotRate already over a_inf
            zero3 = torch.zeros(3, dtype=dtype, device=wvec.device)
            vt = -params.get("machGrid", zero3[0]) * ref.vel_dir
            metrics_list = [
                add_grid_motion(m, x, params.get("rotRate", zero3),
                                params.get("rotCenter", zero3), vt)
                for m, x in zip(metrics_list, x_list)]
        # the interior written into a free-stream template of each block
        w_list = packer.unpack_into(wvec, [winf.expand(s)
                                           for s in pad_shapes])
        return ref, winf, x_list, metrics_list, w_list

    def res(wvec, xvec, params):
        ref, winf, _, metrics_list, w_list = _prep(wvec, xvec, params)
        return packer.pack(residual_list(w_list, metrics_list, topo, cfg,
                                         ref, winf, extras_list))

    def funcs(wvec, xvec, params):
        ref, winf, x_list, metrics_list, w_list = _prep(wvec, xvec, params)
        w_list = fill_halos(w_list, metrics_list, topo, ref, winf)
        f = integrate_forces(w_list, x_list, metrics_list, wall_patches,
                             ref, cfg, extras_list=extras_list, **surface_kw)
        out = cost_functions(f, ref)
        for surf in user_surfaces:
            out.update(integrate_user_surface(w_list, surf, ref))
        return out

    return AdjointFns(res=res, funcs=funcs, pack_x=pack_x,
                      unpack_x=unpack_x)


# ---------------------------------------------------------------------------
# the adjoint linear solve
# ---------------------------------------------------------------------------

@trace.spanned("adjoint.solve")
def solve_adjoint_system(fns: AdjointFns, solver, wvec, xvec, params, rhs,
                         psi0=None, tol=1e-8, abs_tol=None, subspace=100,
                         restarts=8) -> GmresResult:
    """Solve (dR/dw)^T psi = rhs with matrix-free GMRES (reference:
    adjointAPI.F90:661 solveAdjoint + setupPETScKsp:865). The vjp is built
    once here, so the residual's forward (and its kernel) runs once a
    solve and each GMRES iteration runs its backward."""
    _, vjp_w = torch.func.vjp(lambda w: fns.res(w, xvec, params), wvec)

    def matvec(v):
        return vjp_w(v)[0]

    nfns = solver._newton_fns()
    with trace.span("adjoint.pc_build"):
        if str(solver.options["adjointGlobalPreconditioner"]).lower() == \
                "multigrid":
            precond = _transposed_amg_pc(nfns, solver, wvec)
        else:
            precond = _transposed_line_pc(nfns, wvec)

    if bool(solver.options["frozenTurbulence"]) and solver.cfg.rans:
        # frozenTurbulence (reference inputADjoint): the transposed system
        # on the mean-flow rows, the identity on the turbulence rows, so
        # psi_turb = 0 and no dR_turb/dw couplings enter the totals
        packer = nfns.packer
        mask = (torch.arange(packer.nw, device=rhs.device) < 5).to(
            rhs.dtype).repeat(packer.n // packer.nw)
        mv0, pc0 = matvec, precond

        def matvec(v):
            return mask * mv0(mask * v) + (1.0 - mask) * v

        def precond(v):
            return mask * pc0(mask * v) + (1.0 - mask) * v

        rhs = mask * rhs
        if psi0 is not None:
            psi0 = mask * psi0
    # the restart-resolution monitor (reference: adjointMonitorStep and the
    # KSPMonitor of setupPETScKsp, adjointAPI.F90:865)
    monitor_step = int(solver.options["adjointMonitorStep"])
    if not (bool(solver.options["printIterations"]) and monitor_step > 0):
        return gmres(matvec, rhs, x0=psi0, m=subspace, restarts=restarts,
                     tol=tol, atol=abs_tol or 0.0, precond=precond)
    x, sol = psi0, None
    iters = matvecs = next_print = 0
    for _ in range(restarts):
        sol = gmres(matvec, rhs, x0=x, m=subspace, restarts=1, tol=tol,
                    atol=abs_tol or 0.0, precond=precond)
        x = sol.x
        iters += sol.iters
        matvecs += sol.matvecs
        if iters >= next_print or sol.converged:
            print(f"  adjoint GMRES iter {iters:5d}  "
                  f"res {sol.res_norm:.6e}  "
                  f"rel {sol.res_norm / max(sol.b_norm, 1e-300):.3e}")
            next_print = iters + monitor_step
        if sol.converged:
            break
    return sol._replace(iters=iters, matvecs=matvecs)


def _transposed_amg_pc(nfns, solver, wvec):
    """M^-T by the Galerkin stencil multigrid with every level transposed
    (adjointGlobalPreconditioner='multigrid'; Galerkin commutes with the
    transpose for R = P^T, solvers/amg.py stencil_transpose), built once
    at the PC's pseudo-CFL from the solver's metrics and options, as in the
    JAX package."""
    from adflow_torch.solvers.amg import amg_pc_apply, build_amg_pc

    opt = solver.options
    axes = opt["linePCAxes"]
    axes = (1, 0, 2) if (axes == "auto" or axes is None) else tuple(axes)
    w_list, rs_list = nfns.rad_sum_cells(wvec)
    data_list = [
        build_amg_pc(w, m, solver.cfg, solver.ref, dtinv=rs / PC_CFL,
                     levels=int(opt["adjointAMGLevels"]),
                     n_smooth=int(opt["adjointAMGNSmooth"]),
                     axes=axes, kappa=float(opt["linePCKappa"]),
                     transpose=True)
        for w, m, rs in zip(w_list, solver.metrics_list, rs_list)]

    def precond(v):
        vb = nfns.packer.unpack(v)
        return nfns.packer.pack(
            [amg_pc_apply(d, vv) for d, vv in zip(data_list, vb)])

    return precond


def _transposed_line_pc(nfns, wvec):
    """M^-T for the block line-implicit PC (solvers/linpc.py
    line_pc_apply_transposed), built once from the same PC data as NK's."""
    from adflow_torch.solvers.linpc import line_pc_apply_transposed

    data_list = nfns.collect_pc_data(wvec, PC_CFL)

    def precond(v):
        vb = nfns.packer.unpack(v)
        return nfns.packer.pack(
            [line_pc_apply_transposed(d, vv) for d, vv in zip(data_list, vb)])

    return precond
