"""Distributed implicit solvers on the k-split: an ANK step and the adjoint
matvec (counterpart of adflow_tpu/dist/sharded_newton.py; reference: the
PETSc KSP on the global MPI communicator with matrix-free matvecs calling
the halo exchange, NKSolvers.F90:512,3629, and the adjoint KSP on the same
layout, adjointAPI.F90).

Every rank runs the same Krylov program on its local flat vector, every
inner product and norm completed over the process group
(``gmres(group=...)``), and the Jacobian-vector product is
``torch.func.jvp`` through the shard-local residual whose halo fill holds
the ring (dist/comm.py ``KRing``, whose jvp is the ring of the tangent),
so J.v carries the exact cross-rank coupling. The transposed matvec runs
the ring's backward, the reversed ring. The line PC is applied
shard-locally: k-lines stop at shard interfaces, block Jacobi between
ranks (the reference's PETSc ASM(0) across ranks).
"""

from __future__ import annotations

import numpy as np
import torch

from adflow_torch.core.refstate import ReferenceState
from adflow_torch.dist import comm
from adflow_torch.dist.sharded import ShardedProblem, fill_halos_sharded
from adflow_torch.physics.fluxes import spectral_radii
from adflow_torch.physics.residual import ProblemConfig, block_residual
from adflow_torch.physics.thermo import IRHO, IRHOE, pressure
from adflow_torch.physics.timestep import viscous_spectral_radii
from adflow_torch.solvers.krylov import gmres


def _res_local_flat(prob: ShardedProblem, cfg: ProblemConfig,
                    ref: ReferenceState, winf, template, extras):
    """Shard-local flat residual closure (interior DOFs only)."""
    ni, nj, nk = prob.local_dims
    nw = template.shape[-1]
    por = prob.local_topo.blocks[0].por

    def res_flat(wvec, metrics):
        w = template.clone()
        w[2:-2, 2:-2, 2:-2] = wvec.reshape(ni, nj, nk, nw)
        w = fill_halos_sharded(w, metrics, prob, ref, winf)
        return block_residual(w, metrics, cfg, ref, extras,
                              por=por).reshape(-1)

    return res_flat


def _rad_sums(w, metrics, cfg, ref):
    p = torch.clamp(pressure(w), min=1e-10)
    rI, rJ, rK = spectral_radii(w, p, metrics, cfg.ls_precon_mach)
    rs = (rI + rJ + rK)[1:-1, 1:-1, 1:-1]
    if cfg.viscous:
        rv = viscous_spectral_radii(w, metrics, cfg, ref)
        rs = rs + 4.0 * (rv[0] + rv[1] + rv[2])
    return rs


def _template(prob: ShardedProblem, winf, nw, dtype):
    ni, nj, nk = prob.local_dims
    return torch.as_tensor(winf).to(dtype).expand(
        (ni + 4, nj + 4, nk + 4, nw))


def sharded_ank_step(wvec, metrics, prob: ShardedProblem, cfg: ProblemConfig,
                     ref: ReferenceState, winf, cfl, extras=None,
                     m: int = 20, lintol: float = 0.05,
                     turb_cfl_scale: float = 1.0):
    """One distributed ANK step on the shard-local flat state vector
    (mirrors solvers/newton.py make_ank_step with every norm and dot
    reduced over the group). Returns (wvec_new, ||R|| before, ||R|| after,
    relative linear residual), the last three floats equal on every
    rank."""
    group = prob.group
    ni, nj, nk = prob.local_dims
    nw = wvec.numel() // (ni * nj * nk)
    template = _template(prob, winf, nw, wvec.dtype)
    res_flat = _res_local_flat(prob, cfg, ref, winf, template, extras)

    r = res_flat(wvec, metrics)
    rnorm = float(comm.global_norm(r, group))

    w_full = template.clone()
    w_full[2:-2, 2:-2, 2:-2] = wvec.reshape(ni, nj, nk, nw)
    w_full = fill_halos_sharded(w_full, metrics, prob, ref, winf)
    rs = _rad_sums(w_full, metrics, cfg, ref)
    chan = torch.ones((nw,), dtype=wvec.dtype, device=wvec.device)
    rsv = cfg.row_scale(wvec.dtype, wvec.device)
    if rsv is not None:
        chan = chan * rsv
    if turb_cfl_scale != 1.0 and nw > 5:
        chan = torch.cat([chan[:5], chan[5:] / turb_cfl_scale])
    diag = ((rs / cfl)[..., None].expand(rs.shape + (nw,)) * chan).reshape(-1)

    def matvec(v):
        _, jv = torch.func.jvp(lambda u: res_flat(u, metrics), (wvec,), (v,))
        return diag * v + jv

    # shard-local line PC (ASM(0) across ranks)
    from adflow_torch.solvers.linpc import build_line_pc, line_pc_apply
    pc = build_line_pc(w_full, metrics, cfg, ref, dtinv=rs / cfl,
                       axes=(1, 0), kappa=0.25)

    def precond(v):
        return line_pc_apply(pc, v.reshape(ni, nj, nk, nw)).reshape(-1)

    sol = gmres(matvec, -r, m=m, restarts=2, tol=lintol, precond=precond,
                group=group)

    # physicality limit with a global (max-reduced) alpha, so every shard
    # applies the same under-relaxation
    dw = sol.x.reshape(ni, nj, nk, nw)
    wi = wvec.reshape(ni, nj, nk, nw)
    lims = [torch.max(torch.abs(dw[..., idx])
                      / torch.clamp(torch.abs(wi[..., idx]), min=1e-12))
            for idx in (IRHO, IRHOE)]
    if nw > 5:
        # keep turbulence working variables from being driven far negative
        # (physicalityCheckANK turb rows, NKSolvers.F90:3013)
        lims.append(torch.max(-dw[..., 5]
                              / torch.clamp(torch.abs(wi[..., 5]),
                                            min=1e-12)))
    lims = comm.all_max(torch.stack(lims), group).tolist()
    alpha0 = 1.0
    for rel in lims[:2]:
        alpha0 = min(alpha0, 0.2 / max(rel, 0.2))
    if nw > 5:
        alpha0 = min(alpha0, 0.99 / max(lims[2], 0.99))

    # backtracking on the unsteady (backward-Euler) residual, as the
    # single-device make_ank_step: the reduced merit is the same on every
    # shard, so each picks the same alpha (computeUnsteadyResANK,
    # NKSolvers.F90:2614)
    def unsteady_merit(a):
        return float(comm.global_norm(
            diag * (a * sol.x) + res_flat(wvec + a * sol.x, metrics), group))

    alphas = [alpha0, 0.5 * alpha0, 0.25 * alpha0]
    merits = np.array([unsteady_merit(a) for a in alphas])
    alpha = alphas[int(np.argmin(np.where(np.isfinite(merits), merits,
                                          np.inf)))]
    wnew = wvec + alpha * sol.x
    rnew = float(comm.global_norm(res_flat(wnew, metrics), group))
    return wnew, rnorm, rnew, sol.res_norm / max(sol.b_norm, 1e-30)


def sharded_adjoint_matvec(wvec, psi, metrics, prob: ShardedProblem,
                           cfg: ProblemConfig, ref: ReferenceState, winf,
                           extras=None):
    """(dR/dw)^T psi on shard-local flat vectors: the distributed adjoint
    operator. The ring's backward sends the cotangents of the halo cells
    back to the owning shard's interior DOFs."""
    ni, nj, nk = prob.local_dims
    nw = wvec.numel() // (ni * nj * nk)
    template = _template(prob, winf, nw, wvec.dtype)
    res_flat = _res_local_flat(prob, cfg, ref, winf, template, extras)
    _, vjp = torch.func.vjp(lambda u: res_flat(u, metrics), wvec)
    (out,) = vjp(psi)
    return out


def make_sharded_ank_adjoint_step(prob: ShardedProblem, cfg: ProblemConfig,
                                  ref: ReferenceState, cfl: float = 5.0):
    """Each rank's step for the checks: one distributed ANK step, one
    adjoint matvec with psi = 1 and its global norm. ``step(w, metrics,
    winf, d=None)`` on the rank's shard returns (w, [||R|| before, ||R||
    after, linear residual, ||A^T psi||])."""
    ni, nj, nk = prob.local_dims

    def step(w, metrics, winf, d=None):
        extras = None if d is None else {"walldist": d}
        nw = w.shape[-1]
        wvec = w[2:-2, 2:-2, 2:-2].reshape(-1)
        wnew, r0, r1, linres = sharded_ank_step(
            wvec, metrics, prob, cfg, ref, winf, cfl, extras)
        atv = sharded_adjoint_matvec(wnew, torch.ones_like(wnew), metrics,
                                     prob, cfg, ref, winf, extras)
        atn = float(comm.global_norm(atv, prob.group))
        w_out = w.clone()
        w_out[2:-2, 2:-2, 2:-2] = wnew.reshape(ni, nj, nk, nw)
        return w_out, np.array([r0, r1, linres, atn])

    return step
