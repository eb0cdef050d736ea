"""Inviscid fluxes: central + JST scalar dissipation, spectral radii
(counterpart of adflow_tpu/physics/fluxes.py).

Reference analogues (`src/solver/fluxes.F90`): ``inviscidCentralFlux`` (:4)
and ``inviscidDissFluxScalar`` (:1049) — the JST 2nd/4th-difference blend
with a pressure sensor and directionally scaled spectral radii, energy row
differenced on rhoE+p. Written as whole-tensor slicing over the halo-padded
block, without in-place writes, so ``torch.func`` transforms apply.

Shapes for a block with (ni, nj, nk) interior cells:
  w, p: halo-padded (ni+4, nj+4, nk+4, ...)
  si: (ni+1, nj, nk, 3), sj/sk analogous
  returns residual contributions on the interior (ni, nj, nk, 5).

Not ported: the low-speed preconditioner (``precon_mach`` must be 0), the
coarse-level constant dissipation and ALE face velocities.
"""

from __future__ import annotations

from typing import Tuple

import torch

from adflow_torch.core.refstate import GAMMA
from adflow_torch.physics.thermo import IMX, IMZ, IRHO, IRHOE


def _euler_flux(w, p, svec):
    """F(w) . S for conservative w and face-area vector svec (trailing 3)."""
    rho = w[..., IRHO]
    m = w[..., IMX:IMZ + 1]
    q = torch.sum(m * svec, dim=-1) / rho          # u.S
    fmass = rho * q
    fmom = m * q[..., None] + p[..., None] * svec
    fen = (w[..., IRHOE] + p) * q
    return torch.cat([fmass[..., None], fmom, fen[..., None]], dim=-1)


def _shift(a, axis, lo, hi):
    """a sliced [lo : len+hi] along axis (hi <= 0 means from the end)."""
    return a.narrow(axis, lo, a.shape[axis] + hi - lo)


def extended_face_areas(metrics):
    """Face-area arrays on the one-ring extended cell grid."""
    return metrics.siE, metrics.sjE, metrics.skE


def spectral_radii(w, p, metrics, precon_mach: float = 0.0
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Convective spectral radii (radI, radJ, radK) per cell on the one-ring
    extended grid: shape (ni+2, nj+2, nk+2). rad = |u . sAvg| + c |sAvg|."""
    if precon_mach:
        raise NotImplementedError(
            "low-speed preconditioner (ROADMAP.md queue 1 item 9)")
    wE = w[1:-1, 1:-1, 1:-1]
    pE = p[1:-1, 1:-1, 1:-1]
    rho = wE[..., IRHO]
    vel = wE[..., IMX:IMZ + 1] / rho[..., None]
    c = torch.sqrt(GAMMA * pE / rho)

    def rad(sE, axis):
        s_avg = 0.5 * (_shift(sE, axis, 0, -1) + _shift(sE, axis, 1, 0))
        un = torch.sum(vel * s_avg, dim=-1)
        smag = torch.linalg.norm(s_avg, dim=-1)
        return torch.abs(un) + c * smag

    siE, sjE, skE = extended_face_areas(metrics)
    return rad(siE, 0), rad(sjE, 1), rad(skE, 2)


def scaled_diss_radii(radI, radJ, radK, exponent: float):
    """Directional scaling of the dissipation coefficient,
    phi_i = 1 + (radJ/radI)^x + (radK/radI)^x (fluxes.F90 JST scaling)."""
    eps = 1e-30

    def scale(ra, rb, rc):
        return ra * (1.0 + (rb / (ra + eps)) ** exponent
                     + (rc / (ra + eps)) ** exponent)

    return (scale(radI, radJ, radK), scale(radJ, radI, radK),
            scale(radK, radI, radJ))


def inviscid_residual(w, p, metrics, vis2: float, vis4: float,
                      diss_exponent: float = 0.67, por=None):
    """Central + JST residual on the interior, positive = net outflow.

    ``por``: optional per-axis face porosity tensors (1 = normal flux, 0 =
    solid-wall face). At zero-porosity faces the convective velocity and the
    artificial dissipation are switched off so only the pressure acts — the
    reference's boundFlux treatment (fluxes.F90:60-77).

    Returns R with shape (ni, nj, nk, 5).
    """
    radI, radJ, radK = spectral_radii(w, p, metrics)
    sradI, sradJ, sradK = scaled_diss_radii(radI, radJ, radK, diss_exponent)
    nu = _pressure_sensor(p)
    # rhoE+p in the dissipation energy row (5 mean-flow vars only)
    wd = torch.cat([w[..., :IRHOE], (w[..., IRHOE] + p)[..., None]], dim=-1)

    R = None
    for axis, (s, srad) in enumerate(
            [(metrics.si, sradI), (metrics.sj, sradJ), (metrics.sk, sradK)]):
        mask = None if por is None else por[axis]
        flux = _face_flux_axis(w, p, wd, nu, s, srad, axis, vis2, vis4, mask)
        dR = _shift(flux, axis, 1, 0) - _shift(flux, axis, 0, -1)
        R = dR if R is None else R + dR
    return R


def _pressure_sensor(p):
    """JST pressure switch nu = |d2p| / (p_{+1} + 2p + p_{-1}) per cell, on
    the one-ring extended grid, max over the three directions."""
    nu = None
    for axis in range(3):
        pm = _shift(p, axis, 0, -2)
        p0 = _shift(p, axis, 1, -1)
        pp = _shift(p, axis, 2, 0)
        s = torch.abs(pp - 2.0 * p0 + pm) / (pp + 2.0 * p0 + pm)
        idx = [slice(1, -1)] * 3
        idx[axis] = slice(None)
        s = s[tuple(idx)]
        nu = s if nu is None else torch.maximum(nu, s)
    return nu


def _face_flux_axis(w, p, wd, nu, s, srad, axis, vis2, vis4, por=None):
    """Total face flux (central - dissipation) along one axis.

    Face f (0..n_ax) separates interior cells f-1, f; in padded coords the
    four-cell stencil is w[f .. f+3]. Output shape: faces x interior
    tangential x 5.
    """
    it = [slice(2, -2)] * 3
    it[axis] = slice(None)
    it = tuple(it)

    wL = _shift(w, axis, 1, -2)[it]
    wR = _shift(w, axis, 2, -1)[it]
    pL = _shift(p, axis, 1, -2)[it]
    pR = _shift(p, axis, 2, -1)[it]

    qL = torch.sum(wL[..., IMX:IMZ + 1] * s, dim=-1) / wL[..., 0]
    qR = torch.sum(wR[..., IMX:IMZ + 1] * s, dim=-1) / wR[..., 0]
    if por is not None:
        # kill convection at solid faces; pressure remains (boundFlux)
        qL = qL * por
        qR = qR * por
    pa = 0.5 * (pL + pR)
    fmass = 0.5 * (wL[..., 0] * qL + wR[..., 0] * qR)
    fmom = (0.5 * (wL[..., IMX:IMZ + 1] * qL[..., None]
                   + wR[..., IMX:IMZ + 1] * qR[..., None])
            + pa[..., None] * s)
    fen = 0.5 * ((wL[..., IRHOE] + pL) * qL + (wR[..., IRHOE] + pR) * qR)
    central = torch.cat([fmass[..., None], fmom, fen[..., None]], dim=-1)

    # -- JST dissipation: sensor and scaled radius on the one-ring extended
    # grid (n+2); faces need cells f-1 and f -> extended indices f and f+1.
    et = [slice(1, -1)] * 3
    et[axis] = slice(None)
    nuA = nu[tuple(et)]
    srA = srad[tuple(et)]
    lam = 0.5 * (_shift(srA, axis, 0, -1) + _shift(srA, axis, 1, 0))
    eps2 = vis2 * torch.maximum(_shift(nuA, axis, 0, -1),
                                _shift(nuA, axis, 1, 0))
    eps4 = torch.clamp(vis4 - eps2, min=0.0)
    if por is not None:
        eps2 = eps2 * por
        eps4 = eps4 * por

    dL = _shift(wd, axis, 1, -2)[it]
    dR = _shift(wd, axis, 2, -1)[it]
    dLL = _shift(wd, axis, 0, -3)[it]
    dRR = _shift(wd, axis, 3, 0)[it]
    d1 = dR - dL
    d3 = dRR - 3.0 * dR + 3.0 * dL - dLL
    diss = lam[..., None] * (eps2[..., None] * d1 - eps4[..., None] * d3)
    return central - diss
