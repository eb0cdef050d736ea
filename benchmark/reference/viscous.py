# Frozen copy of adflow_torch/physics/viscous.py for the benchmark's reference, its
# imports made local and its SST branch taken out.
"""Viscous (Navier-Stokes) fluxes (counterpart of
adflow_tpu/physics/viscous.py).

Gradients are computed at CELL centers by Green-Gauss and averaged to faces
with a face-normal direction correction (deferred-correction form).
Halo-ring gradients use the edge-replicated face metrics.

Nondimensionalization (core/refstate.py): tau' = mu' grad' u',
heat flux k grad T with k' = mu' / (Pr (gamma-1)), T' = gamma p'/rho'.
The eddy viscosity is SA's or SST's (physics/sst.py); ``useQCR`` adds the
QCR2000 correction to the stress.
"""

from __future__ import annotations

import torch

from .refstate import GAMMA, PR_LAMINAR, PR_TURB
from .fluxes import _max
from .thermo import IMX, IMZ, IRHO, laminar_viscosity


def _shift(a, axis, lo, hi):
    return a.narrow(axis, lo, a.shape[axis] + hi - lo)


def _extended_metrics(metrics):
    """Face areas and volumes covering the one-ring extended cell grid."""
    return metrics.siE, metrics.sjE, metrics.skE, metrics.vol[1:-1, 1:-1, 1:-1]


def green_gauss_gradients(phi, metrics):
    """Cell-center gradients of scalar fields phi on EVERY cell of the
    one-ring extended grid, in the deviatoric form
    grad = (1/V) sum_f (phi_f - phi_c) S_f (exactly zero for constant fields
    even on the non-watertight edge-replicated ghost metrics).

    phi: halo-padded (ni+4, nj+4, nk+4, nf) ->  (ni+2, nj+2, nk+2, nf, 3).
    """
    ext = (slice(1, -1),) * 3
    vol = metrics.vol[ext]
    phc = phi[ext]
    out = 0.0
    for axis, sE in enumerate((metrics.siE, metrics.sjE, metrics.skE)):
        lo = [slice(1, -1)] * 3
        hi = [slice(1, -1)] * 3
        lo[axis] = slice(0, -2)
        hi[axis] = slice(2, None)
        dm = 0.5 * (phi[tuple(lo)] - phc)   # phi_minusface - phi_c
        dp = 0.5 * (phi[tuple(hi)] - phc)   # phi_plusface - phi_c
        s_m = _shift(sE, axis, 0, -1)
        s_p = _shift(sE, axis, 1, 0)
        out = out + (dp[..., None] * s_p[..., None, :]
                     - dm[..., None] * s_m[..., None, :])
    return out / vol[..., None, None]


def _face_gradient(g, phi, xc, axis, it):
    """Face gradients along ``axis`` with normal correction.

    g: cell gradients on extended grid (.., nf, 3); phi: halo-padded fields;
    xc: cell centers on extended grid (.., 3). Output at interior faces:
    (n_ax+1, tang, nf, 3)."""
    et = [slice(1, -1)] * 3
    et[axis] = slice(None)
    gA = g[tuple(et)]
    xA = xc[tuple(et)]
    gbar = 0.5 * (_shift(gA, axis, 0, -1) + _shift(gA, axis, 1, 0))
    delta = _shift(xA, axis, 1, 0) - _shift(xA, axis, 0, -1)

    phA = phi[tuple(it)]
    phL = _shift(phA, axis, 1, -2)
    phR = _shift(phA, axis, 2, -1)

    dist2 = torch.clamp(torch.sum(delta * delta, dim=-1), min=1e-30)
    ehat = delta / torch.sqrt(dist2)[..., None]
    dphi_de = (phR - phL) / torch.sqrt(dist2)[..., None]
    g_e = torch.sum(gbar * ehat[..., None, :], dim=-1)
    corr = (dphi_de - g_e)[..., None] * ehat[..., None, :]
    return gbar + corr


def _viscosity_fields(w, p, metrics, cfg, ref, extras=None):
    """(prim, g, mu_eff, k_eff, mut): primitive fields [u,v,w,T] on the
    padded grid, their Green-Gauss cell gradients, and effective viscosity /
    conductivity on the one-ring extended grid."""
    rho = w[..., IRHO]
    vel = w[..., IMX:IMZ + 1] / rho[..., None]
    t = GAMMA * p / rho
    prim = torch.cat([vel, t[..., None]], dim=-1)        # nf = 4
    g = green_gauss_gradients(prim, metrics)             # (n+2.., 4, 3)
    mu = laminar_viscosity(t[1:-1, 1:-1, 1:-1], ref.mu_inf, ref.t_inf_dim)
    mu_eff = mu
    k_eff = mu / (PR_LAMINAR * (GAMMA - 1.0))
    mut = None
    if cfg.rans:
        from .sa import eddy_viscosity
        mut = eddy_viscosity(w[1:-1, 1:-1, 1:-1], mu)
        mu_eff = mu_eff + mut
        k_eff = k_eff + mut / (PR_TURB * (GAMMA - 1.0))
    return prim, g, mu_eff, k_eff, mut


def face_viscous_flux(w, p, metrics, cfg, ref, axis, extras=None,
                      fields=None, xc_ext=None):
    """Viscous momentum + energy flux (tau . S, q . S) at ALL interior faces
    of one axis: (fmom (faces.., 3), fen (faces..)). Face index 0 is the
    block's low boundary face — the wall-stress source for force
    integration."""
    if fields is None:
        fields = _viscosity_fields(w, p, metrics, cfg, ref, extras)
    prim, g, mu_eff, k_eff, mut = fields
    if xc_ext is None:
        xc_ext = metrics.xc_ext
    it = [slice(2, -2)] * 3
    it[axis] = slice(None)
    gf = _face_gradient(g, prim, xc_ext, axis, it)       # (faces.., 4, 3)
    s = (metrics.si, metrics.sj, metrics.sk)[axis]
    mu_f = _face_avg(mu_eff, axis)
    k_f = _face_avg(k_eff, axis)

    gu = gf[..., 0:3, :]                                 # (faces.., 3, 3)
    div = gu[..., 0, 0] + gu[..., 1, 1] + gu[..., 2, 2]
    eye = torch.eye(3, dtype=w.dtype, device=w.device)
    tauS = (gu + gu.transpose(-1, -2)) - (2.0 / 3.0) * div[..., None, None] * eye
    tau = mu_f[..., None, None] * tauS
    if getattr(cfg, "use_qcr", False) and mut is not None:
        # SA-QCR2000 (fluxes.F90:2742): tau -= Ccr1 mu_t (O_ik tauS_jk +
        # O_jk tauS_ik) with O = 2 W / |grad u| and the vorticity tensor
        # W_ij = du_i/dx_j - du_j/dx_i; only the eddy viscosity enters
        ccr1 = 0.3
        den = torch.sqrt(_max(torch.sum(gu * gu, dim=(-1, -2)), 1e-28))
        W = gu - gu.transpose(-1, -2)
        A = torch.einsum("...ik,...jk->...ij", W, tauS)
        fact = (_face_avg(mut, axis) * ccr1 / den)[..., None, None]
        tau = tau - fact * (A + A.transpose(-1, -2))
    fmom = torch.einsum("...ab,...b->...a", tau, s)

    vel = prim[..., 0:3]
    vL = _shift(vel[tuple(it)], axis, 1, -2)
    vR = _shift(vel[tuple(it)], axis, 2, -1)
    v_f = 0.5 * (vL + vR)
    gT = gf[..., 3, :]
    fen = torch.sum(v_f * fmom, dim=-1) + k_f * torch.sum(gT * s, dim=-1)
    return fmom, fen


def viscous_residual(w, p, metrics, cfg, ref, xc_ext=None, extras=None):
    """Viscous flux residual contribution on the interior, sign convention
    matching inviscid_residual (positive = net outflow): R_visc = -sum_f
    Fv . S_out. Returns (ni, nj, nk, 5)."""
    fields = _viscosity_fields(w, p, metrics, cfg, ref, extras)
    R = 0.0
    for axis in range(3):
        fmom, fen = face_viscous_flux(w, p, metrics, cfg, ref, axis,
                                      extras=extras, fields=fields,
                                      xc_ext=xc_ext)
        flux = torch.cat(
            [torch.zeros_like(fen)[..., None], fmom, fen[..., None]], dim=-1)
        R = R - (_shift(flux, axis, 1, 0) - _shift(flux, axis, 0, -1))
    return R


def _face_avg(c, axis):
    """Average a one-ring-extended cell field to interior faces along axis."""
    et = [slice(1, -1)] * 3
    et[axis] = slice(None)
    cA = c[tuple(et)]
    return 0.5 * (_shift(cA, axis, 0, -1) + _shift(cA, axis, 1, 0))
