"""Menter SST k-omega two-equation turbulence model (counterpart of
adflow_tpu/physics/sst.py; reference SST.F90).

k and omega are carried as w[..., 5:7] (primitive values, like SA's
nuTilde slot) and solved fully coupled inside the one residual. Menter
(1994) standard SST closure in primitive form (rho factored out):
  dk/dt + u.grad k = (P_k - beta* rho k w)/rho
                     + (1/rho) div((mu + sk mut) grad k)
  dw/dt + u.grad w = gamma_b Om^2 - beta w^2
                     + (1/rho) div((mu + sw mut) grad w) + CD_kw
Discretization: upwind advection (first or second order, in the moving
grid's frame under ALE), Green-Gauss + normal-corrected face gradients for
diffusion (shared with physics/viscous.py), vorticity production with the
20 beta* rho k w limiter. Floors and limiters are ``jnp.maximum`` /
``jnp.minimum`` as ``fluxes._max`` / ``_maximum`` (0.5 / 0.5 at a tie,
the selected tangent kept exactly).
"""

from __future__ import annotations

import math

import torch

from adflow_torch.core.refstate import GAMMA
from adflow_torch.geom.metrics import pad_like_numpy
from adflow_torch.physics.fluxes import _max, _maximum, _minimum
from adflow_torch.physics.sa import second_order, upwind_face_value
from adflow_torch.physics.thermo import (
    IMX, IMZ, IRHO, ITURB, laminar_viscosity)
from adflow_torch.physics.viscous import (
    _face_avg, _face_gradient, _shift, green_gauss_gradients)

# closure constants (SST.F90 / paramTurb.F90)
BETA_STAR = 0.09
A1 = 0.31
KARMAN = 0.41
SIGMA_K1, SIGMA_W1, BETA_1 = 0.85, 0.5, 0.075
SIGMA_K2, SIGMA_W2, BETA_2 = 1.0, 0.856, 0.0828
GAMMA_1 = BETA_1 / BETA_STAR - SIGMA_W1 * KARMAN ** 2 / math.sqrt(BETA_STAR)
GAMMA_2 = BETA_2 / BETA_STAR - SIGMA_W2 * KARMAN ** 2 / math.sqrt(BETA_STAR)

IK, IW = ITURB, ITURB + 1
W_FLOOR = 1e-8


def _vorticity(g_vel):
    """|curl u| from a (..., 3, 3) velocity gradient (g[a, b] = du_a/dx_b),
    the square root guarded: vorticity is exactly 0 in uniform flow."""
    wx = g_vel[..., 2, 1] - g_vel[..., 1, 2]
    wy = g_vel[..., 0, 2] - g_vel[..., 2, 0]
    wz = g_vel[..., 1, 0] - g_vel[..., 0, 1]
    return torch.sqrt(_max(wx ** 2 + wy ** 2 + wz ** 2, 1e-32))


def blending_f1(k, w_t, nu, d, cross_kw):
    """Menter F1: 1 near walls (k-omega), 0 outside (k-epsilon)."""
    w_pos = _max(w_t, W_FLOOR)
    k_pos = _max(k, 1e-30)
    cd_kw = _max(2.0 * SIGMA_W2 / w_pos * cross_kw, 1e-20)
    arg1 = _minimum(
        _maximum(torch.sqrt(k_pos) / (BETA_STAR * w_pos * d),
                 500.0 * nu / (d ** 2 * w_pos)),
        4.0 * SIGMA_W2 * k_pos / (cd_kw * d ** 2))
    return torch.tanh(arg1 ** 4)


def blending_f2(k, w_t, nu, d):
    w_pos = _max(w_t, W_FLOOR)
    k_pos = _max(k, 1e-30)
    arg2 = _maximum(2.0 * torch.sqrt(k_pos) / (BETA_STAR * w_pos * d),
                    500.0 * nu / (d ** 2 * w_pos))
    return torch.tanh(arg2 ** 2)


def eddy_viscosity(w, p, metrics, ref, d_ext):
    """mu_t on the one-ring extended grid, rho a1 k / max(a1 w, Om F2)
    (the SST limiter). ``w``, ``p`` halo-padded; ``d_ext`` the wall
    distance on the one-ring extended grid."""
    rho = w[..., IRHO]
    vel = w[..., IMX:IMZ + 1] / rho[..., None]
    mu = laminar_viscosity(GAMMA * p / rho, ref.mu_inf, ref.t_inf_dim)

    om = _vorticity(green_gauss_gradients(vel, metrics))
    ext = (slice(1, -1),) * 3
    rho_e = rho[ext]
    k_e = _max(w[ext][..., IK], 0.0)
    w_e = _max(w[ext][..., IW], W_FLOOR)
    f2 = blending_f2(k_e, w_e, mu[ext] / rho_e, _max(d_ext, 1e-12))
    return rho_e * A1 * k_e / _maximum(A1 * w_e, om * f2)


def sst_residual(w, p, metrics, cfg, ref, d_ext):
    """SST residual on the interior: (ni, nj, nk, 2) for (k, omega), sign
    such that V dq/dt = -R. Halos filled; ``d_ext`` the wall distance on
    the one-ring extended grid."""
    rho = w[..., IRHO]
    vel = w[..., IMX:IMZ + 1] / rho[..., None]
    mu = laminar_viscosity(GAMMA * p / rho, ref.mu_inf, ref.t_inf_dim)
    nu_lam = mu / rho

    it = (slice(2, -2),) * 3
    vol = metrics.vol[it]
    rho_c = rho[it]
    nu_c = nu_lam[it]
    k_c = w[it][..., IK]
    w_c = w[it][..., IW]
    k_pos = _max(k_c, 0.0)
    w_pos = _max(w_c, W_FLOOR)
    d_c = _max(d_ext[1:-1, 1:-1, 1:-1], 1e-12)

    # ---- gradients: u, v, w, k, omega (nf = 5) ---------------------------
    fields = torch.cat([vel, w[..., IK:IW + 1]], dim=-1)
    g = green_gauss_gradients(fields, metrics)
    g_int = g[1:-1, 1:-1, 1:-1]
    om = _vorticity(g_int[..., 0:3, :])
    cross_kw = torch.sum(g_int[..., 3, :] * g_int[..., 4, :], dim=-1)

    f1 = blending_f1(k_pos, w_pos, nu_c, d_c, cross_kw)
    f2 = blending_f2(k_pos, w_pos, nu_c, d_c)
    mut_c = rho_c * A1 * k_pos / _maximum(A1 * w_pos, om * f2)

    beta = f1 * BETA_1 + (1.0 - f1) * BETA_2
    gam = f1 * GAMMA_1 + (1.0 - f1) * GAMMA_2

    # ---- sources (per unit mass, times volume) ---------------------------
    p_k = _minimum(mut_c * om ** 2,
                   20.0 * BETA_STAR * rho_c * k_pos * w_pos)
    src_k = p_k / rho_c - BETA_STAR * k_pos * w_pos
    src_w = (gam * om ** 2 - beta * w_pos ** 2
             + 2.0 * (1.0 - f1) * SIGMA_W2 / w_pos * cross_kw / rho_c)
    Rk = -src_k * vol
    Rw = -src_w * vol

    # ---- advection (upwind) + diffusion per direction --------------------
    nu_eff = nu_lam[1:-1, 1:-1, 1:-1]
    # mu_t on the one-ring grid for the face averages, recomputed there
    nut_e = eddy_viscosity(w, p, metrics, ref, d_ext) / rho[1:-1, 1:-1, 1:-1]
    # F1 on the one-ring grid: the interior F1 edge-padded by one ring
    f1_e = pad_like_numpy(f1, 1, "edge")
    nuk_e = nu_eff + (f1_e * SIGMA_K1 + (1.0 - f1_e) * SIGMA_K2) * nut_e
    nuw_e = nu_eff + (f1_e * SIGMA_W1 + (1.0 - f1_e) * SIGMA_W2) * nut_e
    second = second_order(cfg)
    q_div = adv_k = adv_w = diff_k = diff_w = 0.0
    for axis in range(3):
        s = (metrics.si, metrics.sj, metrics.sk)[axis]
        itx = [slice(2, -2)] * 3
        itx[axis] = slice(None)
        itx = tuple(itx)
        vA = vel[itx]
        q_f = torch.sum(0.5 * (_shift(vA, axis, 1, -2)
                               + _shift(vA, axis, 2, -1)) * s, dim=-1)
        vf = (metrics.vfI, metrics.vfJ, metrics.vfK)[axis]
        if vf is not None:
            # ALE: advect in the moving grid's frame (as in sa.py)
            q_f = q_f - torch.sum(vf * s, dim=-1)

        def div(flux):
            return _shift(flux, axis, 1, 0) - _shift(flux, axis, 0, -1)

        adv_k = adv_k + div(q_f * upwind_face_value(w[itx][..., IK], q_f,
                                                    axis, second))
        adv_w = adv_w + div(q_f * upwind_face_value(w[itx][..., IW], q_f,
                                                    axis, second))
        q_div = q_div + div(q_f)

        gf = _face_gradient(g, fields, metrics.xc_ext, axis, itx)
        diff_k = diff_k + div(_face_avg(nuk_e, axis)
                              * torch.sum(gf[..., 3, :] * s, dim=-1))
        diff_w = diff_w + div(_face_avg(nuw_e, axis)
                              * torch.sum(gf[..., 4, :] * s, dim=-1))

    Rk = Rk + adv_k - k_c * q_div - diff_k
    Rw = Rw + adv_w - w_c * q_div - diff_w

    sk, sw = cfg.turb_scales[:2]
    if sk != 1.0:
        Rk = Rk * sk
    if sw != 1.0:
        Rw = Rw * sw
    return torch.stack([Rk, Rw], dim=-1)
