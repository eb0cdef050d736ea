"""Explicit multistage Runge-Kutta smoother (counterpart of
adflow_tpu/solvers/smoothers.py; reference RungeKuttaSmoother /
executeRkStage, src/solver/smoothers.F90:4,90): 5-stage scheme with local
time stepping, the full residual evaluated per stage.
"""

from __future__ import annotations

from typing import Sequence

import torch

from adflow_torch.physics.residual import (
    MeshTopology, ProblemConfig, block_residual, fill_halos)
from adflow_torch.physics.thermo import pressure
from adflow_torch.physics.timestep import local_timestep

RK_COEFFS = (0.25, 1.0 / 6.0, 0.375, 0.5, 1.0)  # JST 5-stage (smoothers.F90)


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


def rk_iteration(w_list, metrics_list, topo: MeshTopology, cfg: ProblemConfig,
                 ref, winf, cfl, extras_list=None,
                 coeffs: Sequence[float] = RK_COEFFS):
    """One multistage RK iteration on all blocks.

    Returns (new w_list, first-stage residual list). States enter and leave
    with halos *unfilled* (interior authoritative); halos are (re)filled
    internally before each residual evaluation.
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
    # residuals come back with turbResScale-scaled turbulence rows; the
    # explicit update must undo that scaling
    inv_ts = None
    if cfg.rans and any(s != 1.0 for s in cfg.turb_scales):
        inv_ts = torch.tensor([1.0 / s for s in cfg.turb_scales],
                              dtype=w0_list[0].dtype,
                              device=w0_list[0].device)

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
