# Frozen copy of adflow_torch/physics/timestep.py for the benchmark's reference, its
# imports made local.
"""Local (pseudo-)time step from spectral radii (counterpart of
adflow_tpu/physics/timestep.py; reference timeStep_block,
src/solver/solverUtils.F90:43): dt = CFL * V / (radI + radJ + radK + C_v *
viscous radii).
"""

from __future__ import annotations

import torch

from .refstate import GAMMA, PR_LAMINAR, PR_TURB
from .fluxes import spectral_radii
from .thermo import IRHO, laminar_viscosity, temperature

VISCOUS_RADIUS_COEF = 4.0  # reference uses b = 2 (Blazek); conservative


def viscous_spectral_radii(w, metrics, cfg, ref):
    """Viscous spectral radii per interior cell per direction:
    rad_v = max(4/(3 rho), gamma/rho) * (mu/Pr_l + mu_t/Pr_t) * |S|^2 / V."""
    wi = w[2:-2, 2:-2, 2:-2]
    rho = wi[..., IRHO]
    mu = laminar_viscosity(temperature(wi), ref.mu_inf, ref.t_inf_dim)
    mu_eff = mu / PR_LAMINAR
    if cfg.rans:
        from .sa import eddy_viscosity
        mu_eff = mu_eff + eddy_viscosity(wi, mu) / PR_TURB
    fac = max(4.0 / 3.0, GAMMA) * mu_eff / rho
    vol = metrics.vol[2:-2, 2:-2, 2:-2]

    def rad(s, axis):
        n = s.shape[axis]
        s_avg = 0.5 * (s.narrow(axis, 0, n - 1) + s.narrow(axis, 1, n - 1))
        return fac * torch.sum(s_avg * s_avg, dim=-1) / vol

    return (rad(metrics.si, 0), rad(metrics.sj, 1), rad(metrics.sk, 2))


def local_timestep(w, p, metrics, cfl, cfg=None, ref=None):
    """dt per interior cell. w/p halo-padded; returns (ni, nj, nk). The
    radii take ``cfg.ls_precon_mach`` (the low-speed preconditioner)."""
    pm = cfg.ls_precon_mach if cfg is not None else 0.0
    radI, radJ, radK = spectral_radii(w, p, metrics, pm)
    rsum = (radI + radJ + radK)[1:-1, 1:-1, 1:-1]
    if cfg is not None and cfg.viscous and ref is not None:
        rv = viscous_spectral_radii(w, metrics, cfg, ref)
        rsum = rsum + VISCOUS_RADIUS_COEF * (rv[0] + rv[1] + rv[2])
    return cfl * metrics.vol[2:-2, 2:-2, 2:-2] / rsum
