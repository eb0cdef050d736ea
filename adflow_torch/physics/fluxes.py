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

``precon_mach`` > 0 switches on the Weiss-Smith low-speed preconditioner's
eigenvalues in the radii; ALE face velocities (``metrics.vfIE``...) make
the convective speed relative to the moving faces. Where the JAX package
takes ``jnp.maximum`` / ``jnp.minimum`` / ``jnp.clip`` against a constant,
this module takes ``torch.maximum`` / ``torch.minimum`` against a tensor
(``_max``, ``_min``, ``_clip``): both split the derivative 0.5 / 0.5 at a
tie, where ``torch.clamp`` passes 1. Of two tensors whose tangents may be
far apart it takes ``_maximum`` / ``_minimum``.
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


def _const(x, like):
    return torch.as_tensor(x, dtype=like.dtype, device=like.device)


def _max(a, b):
    """``jnp.maximum(a, b)`` for a tensor and a constant."""
    return torch.maximum(a, _const(b, a))


def _min(a, b):
    """``jnp.minimum(a, b)`` for a tensor and a constant."""
    return torch.minimum(a, _const(b, a))


def _maximum(a, b):
    """``jnp.maximum`` of two tensors: the derivative of the larger, half of
    each at a tie. By ``torch.where``: the jvp of ``torch.maximum`` is
    other_t + mask (self_t - other_t), which rounds the selected tangent
    away where the other operand's tangent is far larger (SST's F1 takes
    the minimum of terms some 1e20 apart)."""
    return torch.where(a > b, a, torch.where(a < b, b, 0.5 * (a + b)))


def _minimum(a, b):
    """``jnp.minimum`` of two tensors, as ``_maximum``."""
    return torch.where(a < b, a, torch.where(a > b, b, 0.5 * (a + b)))


def _clip(a, lo, hi):
    """``jnp.clip(a, lo, hi)``: a maximum, then a minimum."""
    return _min(_max(a, lo), hi)


def _abs(x):
    """|x| with the derivative +1 at 0, the JAX package's convention (the
    jvp of ``jnp.abs`` selects on x >= 0; ``torch.abs`` has 0 there). The
    two differ where a state is exactly symmetric, as a free-stream start
    is: zero spanwise velocity on spanwise faces, uniform pressure."""
    return torch.where(x >= 0, x, -x)


def _shift(a, axis, lo, hi):
    """a sliced [lo : len+hi] along axis (hi <= 0 means from the end)."""
    return a.narrow(axis, lo, a.shape[axis] + hi - lo)


def extended_face_areas(metrics):
    """Face-area arrays on the one-ring extended cell grid."""
    return metrics.siE, metrics.sjE, metrics.skE


LS_PRECON_K = 3.0          # beta^2 = clip(max(M^2, K Mref^2), eps, 1)


def spectral_radii(w, p, metrics, precon_mach: float = 0.0
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Convective spectral radii (radI, radJ, radK) per cell on the one-ring
    extended grid: shape (ni+2, nj+2, nk+2). rad = |u . sAvg| + c |sAvg|,
    with u relative to the moving faces under ALE.

    ``precon_mach`` > 0: the Weiss-Smith preconditioned eigenvalue
    (reference lowSpeedPreconditioner, residuals.F90:172-331), the acoustic
    speed rescaled by beta^2 = clip(max(M_loc^2, K Mref^2), 1e-10, 1), so
    dissipation and pseudo-time steps stay O(u) as M -> 0."""
    wE = w[1:-1, 1:-1, 1:-1]
    pE = p[1:-1, 1:-1, 1:-1]
    rho = wE[..., IRHO]
    vel = wE[..., IMX:IMZ + 1] / rho[..., None]
    c2 = GAMMA * pE / rho
    c = torch.sqrt(c2)
    beta2 = None
    if precon_mach and precon_mach > 0.0:
        m2 = torch.sum(vel * vel, dim=-1) / c2
        beta2 = _clip(_max(m2, LS_PRECON_K * precon_mach ** 2), 1e-10, 1.0)

    def rad(sE, vfE, axis):
        s_avg = 0.5 * (_shift(sE, axis, 0, -1) + _shift(sE, axis, 1, 0))
        un = torch.sum(vel * s_avg, dim=-1)
        if vfE is not None:
            vf_avg = 0.5 * (_shift(vfE, axis, 0, -1)
                            + _shift(vfE, axis, 1, 0))
            un = un - torch.sum(vf_avg * s_avg, dim=-1)
        smag = torch.linalg.norm(s_avg, dim=-1)
        if beta2 is None:
            return _abs(un) + c * smag
        # lam = 0.5 (1+b2)|un| + sqrt(0.25 (1-b2)^2 un^2 + b2 c^2 |S|^2);
        # b2 = 1 recovers |un| + c|S|
        return (0.5 * (1.0 + beta2) * _abs(un)
                + torch.sqrt(0.25 * (1.0 - beta2) ** 2 * un * un
                             + beta2 * c2 * smag * smag))

    siE, sjE, skE = extended_face_areas(metrics)
    return (rad(siE, metrics.vfIE, 0), rad(sjE, metrics.vfJE, 1),
            rad(skE, metrics.vfKE, 2))


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
                      diss_exponent: float = 0.67, por=None,
                      const_diss: bool = False, precon_mach: float = 0.0):
    """Central + JST residual on the interior, positive = net outflow.

    ``por``: optional per-axis face porosity tensors (1 = normal flux, 0 =
    solid-wall face). At zero-porosity faces the convective velocity and the
    artificial dissipation are switched off so only the pressure acts — the
    reference's boundFlux treatment (fluxes.F90:60-77).
    ``const_diss``: the coarse-level dissipation, a constant vis2
    2nd-difference without the sensor and without the 4th difference.
    ``precon_mach``: the low-speed preconditioner's radii (``spectral_radii``).

    Returns R with shape (ni, nj, nk, 5).
    """
    radI, radJ, radK = spectral_radii(w, p, metrics, precon_mach)
    sradI, sradJ, sradK = scaled_diss_radii(radI, radJ, radK, diss_exponent)
    nu = _pressure_sensor(p)
    # rhoE+p in the dissipation energy row (5 mean-flow vars only)
    wd = torch.cat([w[..., :IRHOE], (w[..., IRHOE] + p)[..., None]], dim=-1)

    R = None
    for axis, (s, srad, vf) in enumerate(
            [(metrics.si, sradI, metrics.vfI),
             (metrics.sj, sradJ, metrics.vfJ),
             (metrics.sk, sradK, metrics.vfK)]):
        mask = None if por is None else por[axis]
        flux = _face_flux_axis(w, p, wd, nu, s, srad, axis, vis2, vis4, mask,
                               const_diss, vf=vf)
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
        s = _abs(pp - 2.0 * p0 + pm) / (pp + 2.0 * p0 + pm)
        idx = [slice(1, -1)] * 3
        idx[axis] = slice(None)
        s = s[tuple(idx)]
        nu = s if nu is None else torch.maximum(nu, s)
    return nu


def _face_flux_axis(w, p, wd, nu, s, srad, axis, vis2, vis4, por=None,
                    const_diss: bool = False, vf=None):
    """Total face flux (central - dissipation) along one axis.

    Face f (0..n_ax) separates interior cells f-1, f; in padded coords the
    four-cell stencil is w[f .. f+3]. Output shape: faces x interior
    tangential x 5. ``vf``: ALE face velocity vectors (the shape of ``s``):
    the convective velocity becomes relative to the moving face and the
    energy row gains the face work p (vf . S), which survives at solid
    moving walls (inviscidCentralFlux with sFace, fluxes.F90:4).
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
    sdot = None if vf is None else torch.sum(vf * s, dim=-1)
    if sdot is not None:
        qL = qL - sdot
        qR = qR - sdot
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
    if sdot is not None:
        fen = fen + pa * sdot
    central = torch.cat([fmass[..., None], fmom, fen[..., None]], dim=-1)

    # -- JST dissipation: sensor and scaled radius on the one-ring extended
    # grid (n+2); faces need cells f-1 and f -> extended indices f and f+1.
    et = [slice(1, -1)] * 3
    et[axis] = slice(None)
    nuA = nu[tuple(et)]
    srA = srad[tuple(et)]
    lam = 0.5 * (_shift(srA, axis, 0, -1) + _shift(srA, axis, 1, 0))
    if const_diss:
        # coarse-grid dissipation: constant 2nd difference only, no sensor
        # (fluxes.F90 inviscidDissFluxScalarCoarse:4977, vis2Coarse)
        eps2 = torch.full_like(lam, vis2)
        eps4 = torch.zeros_like(lam)
    else:
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
