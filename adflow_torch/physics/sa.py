"""Spalart-Allmaras one-equation turbulence model (counterpart of
adflow_tpu/physics/sa.py).

The nuTilde equation is carried as w[..., 5] and solved fully coupled.
Standard SA-noft2/ft2 closure (Spalart & Allmaras 1994):
  d(nuT)/dt + u.grad(nuT) = cb1 (1-ft2) S~ nuT
      - (cw1 fw - cb1/k^2 ft2)(nuT/d)^2
      + 1/sigma [ div((nu+nuT) grad nuT) + cb2 (grad nuT)^2 ]
Discretization: upwind advection, first order or (``turbulenceOrder:
'second order'``) van-Albada-limited MUSCL, in the frame of the moving grid
under ALE; Green-Gauss + normal-corrected face gradients for diffusion
(shared scheme with physics/viscous.py). Variants: rotation-SA
(Dacles-Mariani) and SA-Edwards (no ft2; ft2 is kept for model 'sa' only).
"""

from __future__ import annotations

import torch

from adflow_torch.core.refstate import GAMMA
from adflow_torch.physics.fluxes import _max, _min
from adflow_torch.physics.thermo import IMX, IMZ, IRHO, ITURB, laminar_viscosity
from adflow_torch.physics.viscous import (
    _face_avg, _face_gradient, _shift, green_gauss_gradients)

# closure constants (sa.F90 / paramTurb.F90)
CB1 = 0.1355
CB2 = 0.622
SIGMA = 2.0 / 3.0
KARMAN = 0.41
CW1 = CB1 / KARMAN ** 2 + (1.0 + CB2) / SIGMA
CW2 = 0.3
CW3 = 2.0
CV1 = 7.1
CT3 = 1.2
CT4 = 0.5


def eddy_viscosity(w, mu):
    """mu_t = rho nuTilde fv1 (zero for negative nuTilde). ``w`` cell states
    with the turbulence slot, ``mu`` laminar viscosity, same shape."""
    rho = w[..., IRHO]
    nut = torch.clamp(w[..., ITURB], min=0.0)
    chi = rho * nut / mu
    fv1 = chi ** 3 / (chi ** 3 + CV1 ** 3)
    return rho * nut * fv1


def sa_destruction_diag(w, metrics, d_ext):
    """Positive part of d(R_sa)/d(nuTilde) from the destruction term
    (per-cell, includes the volume factor), for the point-implicit treatment
    of the stiff near-wall source in the explicit smoother. cw1*fw is
    bounded by its maximum (fw <= (1+cw3^6)^(1/6))."""
    it = (slice(2, -2),) * 3
    nut_c = torch.clamp(w[it][..., ITURB], min=0.0)
    d_c = torch.clamp(d_ext[1:-1, 1:-1, 1:-1], min=1e-12)
    fw_max = (1.0 + CW3 ** 6) ** (1.0 / 6.0)
    return 2.0 * CW1 * fw_max * nut_c / d_c ** 2 * metrics.vol[it]


def second_order(cfg) -> bool:
    """turbulenceOrder 'second order' (doc/options.yaml:198)."""
    return cfg.turb_order.replace(" ", "").lower() == "secondorder"


def upwind_face_value(qA, q_f, axis, second: bool):
    """The upwind face value of the advected cell field ``qA`` (padded along
    ``axis``, interior across it) at the faces of ``axis`` with normal
    speed ``q_f``: the neighbour cell (first order) or its
    van-Albada-limited MUSCL extrapolation (second order)."""
    qL = _shift(qA, axis, 1, -2)
    qR = _shift(qA, axis, 2, -1)
    if second:
        from adflow_torch.physics.upwind import _van_albada
        dc = qR - qL
        qL = qL + 0.5 * _van_albada(qL - _shift(qA, axis, 0, -3), dc)
        qR = qR - 0.5 * _van_albada(_shift(qA, axis, 3, 0) - qR, dc)
    return torch.where(q_f >= 0.0, qL, qR)


def sa_residual(w, p, metrics, cfg, ref, d_ext):
    """SA residual on the interior: (ni, nj, nk, 1), sign such that
    V d(nuT)/dt = -R. Halos of w filled; d_ext: wall distance on the
    one-ring extended grid (geom/walldist.py)."""
    rho = w[..., IRHO]
    vel = w[..., IMX:IMZ + 1] / rho[..., None]
    nut = w[..., ITURB]
    t = GAMMA * p / rho
    mu = laminar_viscosity(t, ref.mu_inf, ref.t_inf_dim)
    nu_lam = mu / rho

    it = (slice(2, -2),) * 3
    nut_c = nut[it]
    nu_c = nu_lam[it]
    vol = metrics.vol[it]
    d_c = torch.clamp(d_ext[1:-1, 1:-1, 1:-1], min=1e-12)

    # ---- gradients (velocity for vorticity, nuTilde for diffusion) ------
    fields = torch.cat([vel, nut[..., None]], dim=-1)      # nf = 4
    g = green_gauss_gradients(fields, metrics)             # (n+2.., 4, 3)
    g_int = g[1:-1, 1:-1, 1:-1]
    gu = g_int[..., 0:3, :]
    wx = gu[..., 2, 1] - gu[..., 1, 2]
    wy = gu[..., 0, 2] - gu[..., 2, 0]
    wz = gu[..., 1, 0] - gu[..., 0, 1]
    # guarded sqrt: omega is exactly 0 in uniform flow
    omega = torch.sqrt(torch.clamp(wx ** 2 + wy ** 2 + wz ** 2, min=1e-32))
    if cfg.use_rotation_sa:
        # Dacles-Mariani rotation correction (useRotationSA, sa.F90):
        # S = omega + 2 min(0, |strain| - |vort|)
        sxy = 0.5 * (gu[..., 0, 1] + gu[..., 1, 0])
        sxz = 0.5 * (gu[..., 0, 2] + gu[..., 2, 0])
        syz = 0.5 * (gu[..., 1, 2] + gu[..., 2, 1])
        strain2 = (2.0 * (sxy ** 2 + sxz ** 2 + syz ** 2) + gu[..., 0, 0] ** 2
                   + gu[..., 1, 1] ** 2 + gu[..., 2, 2] ** 2)
        strain = torch.sqrt(_max(2.0 * strain2, 1e-32))
        omega = omega + 2.0 * _min(strain - omega, 0.0)
    gnut = g_int[..., 3, :]
    gnut2 = torch.sum(gnut * gnut, dim=-1)

    # ---- source terms ----------------------------------------------------
    nut_pos = torch.clamp(nut_c, min=1e-14)
    chi = nut_pos / nu_c
    fv1 = chi ** 3 / (chi ** 3 + CV1 ** 3)
    fv2 = 1.0 - chi / (1.0 + chi * fv1)
    inv_k2d2 = 1.0 / (KARMAN ** 2 * d_c ** 2)
    s_tilde = omega + nut_pos * fv2 * inv_k2d2
    s_tilde = torch.maximum(s_tilde, 0.3 * omega + 1e-16)

    ft2 = (CT3 * torch.exp(-CT4 * chi ** 2)
           if (cfg.use_ft2 and cfg.turbulence_model == "sa") else 0.0)

    r = torch.clamp(nut_pos * inv_k2d2 / s_tilde, max=10.0)
    g_fw = r + CW2 * (r ** 6 - r)
    # clamp g: bounds the g^6 tangent in f32 without changing fw
    g_fw = torch.clamp(g_fw, max=100.0)
    fw = g_fw * ((1.0 + CW3 ** 6) / (g_fw ** 6 + CW3 ** 6)) ** (1.0 / 6.0)

    prod = CB1 * (1.0 - ft2) * s_tilde * nut_c
    destr = (CW1 * fw - CB1 / KARMAN ** 2 * ft2) * (nut_c / d_c) ** 2
    R = -(prod - destr) * vol
    # cb2 gradient-squared volume term of the diffusion operator
    R = R - (CB2 / SIGMA) * gnut2 * vol

    # ---- advection (upwind) + diffusion, per direction -------------------
    nu_eff = (nu_lam + torch.clamp(nut, min=0.0))[1:-1, 1:-1, 1:-1]
    second = second_order(cfg)
    q_div = 0.0
    for axis in range(3):
        s = (metrics.si, metrics.sj, metrics.sk)[axis]
        itx = [slice(2, -2)] * 3
        itx[axis] = slice(None)
        itx = tuple(itx)
        vA = vel[itx]
        vL = _shift(vA, axis, 1, -2)
        vR = _shift(vA, axis, 2, -1)
        q_f = torch.sum(0.5 * (vL + vR) * s, dim=-1)      # u_f . S_f
        vf = (metrics.vfI, metrics.vfJ, metrics.vfK)[axis]
        if vf is not None:
            # ALE: advect in the frame of the moving grid (turbUtils.F90)
            q_f = q_f - torch.sum(vf * s, dim=-1)
        flux_adv = q_f * upwind_face_value(nut[itx], q_f, axis, second)
        R = R + (_shift(flux_adv, axis, 1, 0) - _shift(flux_adv, axis, 0, -1))
        q_div = q_div + (_shift(q_f, axis, 1, 0) - _shift(q_f, axis, 0, -1))

        # diffusion: (1/sigma) (nu+nuT)_f  grad(nuT)_f . S_f
        gf = _face_gradient(g, fields, metrics.xc_ext, axis, itx)
        nue_f = _face_avg(nu_eff, axis)
        flux_diff = (1.0 / SIGMA) * nue_f * torch.sum(gf[..., 3, :] * s, dim=-1)
        R = R - (_shift(flux_diff, axis, 1, 0)
                 - _shift(flux_diff, axis, 0, -1))

    # non-conservative correction: int u.grad nuT = surface flux - nuT div u
    R = R - nut_c * q_div

    s = cfg.turb_scales[0]
    if s != 1.0:
        R = R * s
    return R[..., None]
