"""The smoothers (counterpart of adflow_tpu/solvers/smoothers.py):

- the explicit multistage Runge-Kutta smoother (reference
  RungeKuttaSmoother / executeRkStage, src/solver/smoothers.F90:4,90):
  5-stage scheme with local time stepping, the full residual evaluated per
  stage;
- the DADI smoother (reference DADISmoother / executeDADIStep,
  smoothers.F90:383,425): one implicit update through the three-axis line
  preconditioner of solvers/linpc.py, as the JAX package runs it;
- implicit residual averaging (residuals.F90:1785), which multigrid's
  smoother applies at every stage: the smoothing kernel
  (``ops/cuda_irs.py``) on float32 CUDA blocks, else the plain sweeps.
"""

from __future__ import annotations

from typing import Sequence

import torch

from adflow_torch.ops import cuda_irs
from adflow_torch.physics.residual import (
    MeshTopology, ProblemConfig, block_residual, fill_halos)
from adflow_torch.physics.thermo import pressure
from adflow_torch.physics.timestep import local_timestep
from adflow_torch.utils import trace

RK_COEFFS = (0.25, 1.0 / 6.0, 0.375, 0.5, 1.0)  # JST 5-stage (smoothers.F90)


def _irs_kernel_applies(r) -> bool:
    """Whether the smoothing of ``r`` is what the smoothing kernel computes
    (``ops/cuda_irs.py``): a float32 (n0, n1, n2, nv) block on CUDA with nv
    of ``cuda_irs.NV``, autograd not recording through it and no
    ``torch.func`` level around it (the kernel has no derivative rule)."""
    return (r.is_cuda and r.dtype == torch.float32 and r.dim() == 4
            and r.shape[-1] in cuda_irs.NV
            and not (torch.is_grad_enabled() and r.requires_grad)
            and not torch._C._functorch.is_functorch_wrapped_tensor(r))


@trace.spanned("smoother.irs")
def residual_averaging(r, eps: float):
    """Implicit residual smoothing: (I - eps d^2)^-1 r per direction
    (reference: residualAveraging, residuals.F90:1785), which extends the
    RK stability region so multigrid can run a higher CFL on stretched
    meshes. r: (ni, nj, nk, nv); a constant coefficient eps. The smoothing
    kernel, one launch an axis, where ``_irs_kernel_applies``; else the
    plain sweeps (``plain_residual_averaging``)."""
    if _irs_kernel_applies(r):
        return cuda_irs.smooth(r, eps)
    return plain_residual_averaging(r, eps)


def plain_residual_averaging(r, eps: float):
    """The plain smoothing. The JAX package runs a Thomas recurrence over
    full coefficient arrays; here the line's factors are computed once
    (``cuda_irs.line_factors``: they are the same for every line, and kept
    on the device), and a solve is one multiply-add per cell along the line
    in each direction, which changes the result by round-off only."""
    from adflow_torch.solvers.dadi import tridiag_solve_factored
    for axis in range(3):
        n = r.shape[axis]
        if n < 3:
            continue
        shape = (n,) + (1,) * (r.dim() - 2)
        lines = tuple(d for i, d in enumerate(r.shape[:-1]) if i != axis)
        factors = [a.reshape(shape).expand((n,) + lines)
                   for a in cuda_irs.line_factors(n, float(eps), r.dtype,
                                                  r.device)]
        rm = torch.movedim(r, axis, 0)
        r = torch.movedim(tridiag_solve_factored(factors, rm), 0, axis)
    return r


def residual_norms(r_list: Sequence[torch.Tensor], n_mean: int = 5):
    """(||R_meanflow||_2, ||R_turb||_2) over all blocks — the reference's
    resrho / resturb monitors."""
    s_mean = torch.zeros((), dtype=r_list[0].dtype, device=r_list[0].device)
    s_turb = torch.zeros_like(s_mean)
    for r in r_list:
        s_mean = s_mean + torch.sum(r[..., :n_mean] ** 2)
        if r.shape[-1] > n_mean:
            s_turb = s_turb + torch.sum(r[..., n_mean:] ** 2)
    return torch.sqrt(s_mean), torch.sqrt(s_turb)


def _with_interior(w, interior):
    """Copy of padded ``w`` whose interior is ``interior`` (out of place, so
    no stage aliases another stage's state)."""
    out = w.clone()
    out[2:-2, 2:-2, 2:-2] = interior
    return out


def turb_unscale(cfg: ProblemConfig, dtype, device):
    """(n_turb,) 1 / turbResScale on ``device``, which the explicit update
    multiplies into the turbulence rows (the residuals come back with them
    scaled), or None where no row is scaled. A copy from the host: made
    once a solve, not once an iteration."""
    if not cfg.rans or all(s == 1.0 for s in cfg.turb_scales):
        return None
    return torch.tensor([1.0 / s for s in cfg.turb_scales], dtype=dtype,
                        device=device)


def rk_iteration(w_list, metrics_list, topo: MeshTopology, cfg: ProblemConfig,
                 ref, winf, cfl, extras_list=None,
                 coeffs: Sequence[float] = RK_COEFFS, inv_ts=None):
    """One multistage RK iteration on all blocks.

    Returns (new w_list, first-stage residual list). States enter and leave
    with halos *unfilled* (interior authoritative); halos are (re)filled
    internally before each residual evaluation. ``inv_ts``: the solve's
    ``turb_unscale``, made here where not given.
    """
    w0_list = fill_halos(w_list, metrics_list, topo, ref, winf)
    # frozen local dt over the stages
    dt_list = [local_timestep(w, pressure(w), m, cfl, cfg, ref)
               / m.vol[2:-2, 2:-2, 2:-2]
               for w, m in zip(w0_list, metrics_list)]

    # point-implicit diagonal for the stiff SA destruction term (frozen over
    # the stages like dt); see sa.sa_destruction_diag
    diag_list = [None] * len(w0_list)
    if cfg.rans and cfg.turbulence_model == "sa" and extras_list:
        from adflow_torch.physics.sa import sa_destruction_diag
        diag_list = [
            sa_destruction_diag(w, m, extras_list[i]["walldist"])
            for i, (w, m) in enumerate(zip(w0_list, metrics_list))]

    nmf = 5  # mean-flow channel count
    if inv_ts is None:
        inv_ts = turb_unscale(cfg, w0_list[0].dtype, w0_list[0].device)

    r0_list = None
    wk_list = w0_list
    for alpha in coeffs:
        r_list = [block_residual(w, m, cfg, ref,
                                 extras_list[i] if extras_list else None,
                                 por=topo.blocks[i].por)
                  for i, (w, m) in enumerate(zip(wk_list, metrics_list))]
        if r0_list is None:
            r0_list = r_list
        new = []
        for w0, r, dtv, diag in zip(w0_list, r_list, dt_list, diag_list):
            if r.shape[-1] > nmf and (diag is not None or inv_ts is not None):
                rt = r[..., nmf:]
                if inv_ts is not None:
                    rt = rt * inv_ts
                if diag is not None:
                    rt = rt / (1.0 + alpha * dtv * diag)[..., None]
                r = torch.cat([r[..., :nmf], rt], dim=-1)
            upd = w0[2:-2, 2:-2, 2:-2] - alpha * dtv[..., None] * r
            new.append(_with_interior(w0, upd))
        wk_list = fill_halos(new, metrics_list, topo, ref, winf)
    return wk_list, r0_list


def dadi_iteration(w_list, metrics_list, topo: MeshTopology,
                   cfg: ProblemConfig, ref, winf, cfl, extras_list=None):
    """One diagonalized-ADI implicit smoother iteration on all blocks
    (reference DADISmoother / executeDADIStep, smoothers.F90:383,425): the
    factored update (D + A_i)(D + A_j)(D + A_k) dz = R with D = V/dt, whose
    factors are the line-implicit operators of solvers/linpc.py (the exact
    signed 5x5 flux Jacobians with the spectral-radius split, along all
    three axes), as in the JAX package. One residual evaluation a block an
    iteration. The same in/out contract as ``rk_iteration``; the scaled
    turbulence rows are handled by the PC itself."""
    from adflow_torch.physics.fluxes import spectral_radii
    from adflow_torch.physics.timestep import viscous_spectral_radii
    from adflow_torch.solvers.linpc import build_line_pc, line_pc_apply

    w0_list = fill_halos(w_list, metrics_list, topo, ref, winf)
    r_list = [block_residual(w, m, cfg, ref,
                             extras_list[i] if extras_list else None,
                             por=topo.blocks[i].por)
              for i, (w, m) in enumerate(zip(w0_list, metrics_list))]
    new = []
    for i, (w, m, r) in enumerate(zip(w0_list, metrics_list, r_list)):
        p = torch.clamp(pressure(w), min=1e-10)
        rI, rJ, rK = spectral_radii(w, p, m, cfg.ls_precon_mach)
        rs = (rI + rJ + rK)[1:-1, 1:-1, 1:-1]
        if cfg.viscous:
            rv = viscous_spectral_radii(w, m, cfg, ref)
            rs = rs + 4.0 * (rv[0] + rv[1] + rv[2])
        dtinv = rs / cfl                           # V/dt per cell
        if r.shape[-1] > 5 and cfg.turbulence_model == "sa" and extras_list:
            # fold the stiff SA destruction diagonal into the turbulence
            # rows (the PC's turbulence operator has only advection + dt)
            from adflow_torch.physics.sa import sa_destruction_diag
            diag = sa_destruction_diag(w, m, extras_list[i]["walldist"])
            rt = r[..., 5:] / (1.0 + diag / dtinv)[..., None]
            r = torch.cat([r[..., :5], rt], dim=-1)
        data = build_line_pc(w, m, cfg, ref, dtinv, axes=(0, 1, 2))
        new.append(_with_interior(w, w[2:-2, 2:-2, 2:-2]
                                  - line_pc_apply(data, r)))
    return new, r_list
