"""The explicit five-stage Runge-Kutta cycle with local time stepping and
the point-implicit SA destruction diagonal, and the residual norms the
solver reports: a frozen copy of ``rk_iteration`` and ``residual_norms``
of adflow_torch's ``solvers/smoothers.py``."""

from __future__ import annotations

from typing import Sequence

import torch

from .residual import MeshTopology, ProblemConfig, block_residual, fill_halos
from .thermo import pressure
from .timestep import local_timestep

RK_COEFFS = (0.25, 1.0 / 6.0, 0.375, 0.5, 1.0)  # JST 5-stage


def residual_norms(r_list: Sequence[torch.Tensor], n_mean: int = 5):
    """(||R_meanflow||_2, ||R_turb||_2) over all blocks."""
    s_mean = torch.zeros((), dtype=r_list[0].dtype, device=r_list[0].device)
    s_turb = torch.zeros_like(s_mean)
    for r in r_list:
        s_mean = s_mean + torch.sum(r[..., :n_mean] ** 2)
        if r.shape[-1] > n_mean:
            s_turb = s_turb + torch.sum(r[..., n_mean:] ** 2)
    return torch.sqrt(s_mean), torch.sqrt(s_turb)


def _with_interior(w, interior):
    out = w.clone()
    out[2:-2, 2:-2, 2:-2] = interior
    return out


def rk_iteration(w_list, metrics_list, topo: MeshTopology, cfg: ProblemConfig,
                 ref, winf, cfl, extras_list=None,
                 coeffs: Sequence[float] = RK_COEFFS):
    """One multistage RK iteration on all blocks: (new w_list, first-stage
    residual list). The local time step and the SA destruction diagonal are
    frozen over the stages."""
    w0_list = fill_halos(w_list, metrics_list, topo, ref, winf)
    dt_list = [local_timestep(w, pressure(w), m, cfl, cfg, ref)
               / m.vol[2:-2, 2:-2, 2:-2]
               for w, m in zip(w0_list, metrics_list)]
    diag_list = [None] * len(w0_list)
    if cfg.rans and extras_list:
        from .sa import sa_destruction_diag
        diag_list = [sa_destruction_diag(w, m, extras_list[i]["walldist"])
                     for i, (w, m) in enumerate(zip(w0_list, metrics_list))]
    nmf = 5
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
