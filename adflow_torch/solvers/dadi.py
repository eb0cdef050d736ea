"""Scalar line solves and the scalar diagonalized-ADI operator
(counterpart of adflow_tpu/solvers/dadi.py).

- ``tridiag_solve``: the batched Thomas algorithm, the turbulence line
  solve of the line preconditioner and of multigrid's residual averaging.
  The JAX package runs the recurrence as two ``lax.scan``s. Here the
  forward elimination is factored once (``tridiag_factor``: it depends only
  on the coefficients), so a solve is one multiply-add per cell along the
  line in each direction (``tridiag_solve_factored``). That changes the
  result by round-off only.
- ``build_dadi_data`` / ``dadi_apply``: the scalar approximate
  factorization (D + A_i) D^-1 (D + A_j) D^-1 (D + A_k) with D = V/dt and
  A_dir the first-order scalar model of the directional flux Jacobian
  (tridiagonal along each line: diagonal 0.5 (lam_minus + lam_plus),
  off-diagonals -0.5 lam). Public functions of the JAX module, which
  nothing in either package calls: the DADI smoother (reference
  DADISmoother, smoothers.F90:383) is ``smoothers.dadi_iteration``, which
  runs the line preconditioner of solvers/linpc.py along three axes.
"""

from __future__ import annotations

import torch

from adflow_torch.geom.metrics import pad_like_numpy
from adflow_torch.physics.fluxes import spectral_radii
from adflow_torch.physics.thermo import pressure
from adflow_torch.physics.timestep import viscous_spectral_radii


def tridiag_factor(lower, diag, upper):
    """Forward-elimination factors of the tridiagonal systems along axis 0.

    lower/diag/upper: (n, ...) coefficients (lower[0] and upper[-1]
    ignored). Returns (g, denom, cp), each (n, ...): the eliminated
    row is x_c = (d_c - lower_c x_{c-1}) / denom_c, g = lower / denom and
    cp = upper / denom. Not pivoted — valid for the diagonally dominant PC
    systems built here; a vanishing pivot is floored as in the JAX package.
    """
    n = diag.shape[0]
    g = torch.empty_like(diag)
    den = torch.empty_like(diag)
    cp = torch.empty_like(diag)
    cp_prev = torch.zeros_like(diag[0])
    for c in range(n):
        denom = diag[c] - lower[c] * cp_prev
        denom = torch.where(torch.abs(denom) < 1e-30,
                            torch.sign(denom) * 1e-30 + 1e-30, denom)
        den[c] = denom
        g[c] = lower[c] / denom
        cp[c] = upper[c] / denom
        cp_prev = cp[c]
    return g, den, cp


def tridiag_solve_factored(factors, rhs):
    """Solve with the factors of ``tridiag_factor``; rhs (n, ..., nv)."""
    g, den, cp = factors
    n = rhs.shape[0]
    x = rhs / den[..., None]
    for c in range(1, n):
        x[c].addcmul_(g[c][..., None], x[c - 1], value=-1.0)
    for c in range(n - 2, -1, -1):
        x[c].addcmul_(cp[c][..., None], x[c + 1], value=-1.0)
    return x


def tridiag_solve_factored_transposed(factors, rhs):
    """Solve with the transposed systems, T^T x = rhs, from the factors of
    T by ``tridiag_factor``: T = diag(denom) (I + N_g) U_cp with N_g the
    subdiagonal g and U_cp the unit upper bidiagonal of cp, so T^-T =
    diag(denom)^-1 (I + N_g)^-T U_cp^-T: a forward sweep with cp, a
    backward sweep with g, then the division."""
    g, den, cp = factors
    n = rhs.shape[0]
    x = rhs.clone()
    for c in range(1, n):
        x[c].addcmul_(cp[c - 1][..., None], x[c - 1], value=-1.0)
    for c in range(n - 2, -1, -1):
        x[c].addcmul_(g[c + 1][..., None], x[c + 1], value=-1.0)
    return x / den[..., None]


def tridiag_solve(lower, diag, upper, rhs):
    """Batched Thomas algorithm along axis 0.

    lower/diag/upper: (n, ...) coefficient arrays (lower[0] and upper[-1]
    ignored); rhs: (n, ..., nv). Returns the solution with rhs's shape.
    """
    return tridiag_solve_factored(tridiag_factor(lower, diag, upper), rhs)


def _face_lambdas(rad_ext, axis):
    """(lam_minus, lam_plus) per interior cell from the one-ring-extended
    per-cell spectral radius: lam at a face = mean of the adjacent cells'."""
    sl_lo = [slice(1, -1)] * 3
    sl_hi = [slice(1, -1)] * 3
    sl_lo[axis] = slice(0, -2)
    sl_hi[axis] = slice(2, None)
    rc = rad_ext[1:-1, 1:-1, 1:-1]
    return (0.5 * (rad_ext[tuple(sl_lo)] + rc),
            0.5 * (rad_ext[tuple(sl_hi)] + rc))


class DadiData:
    """Per-block frozen coefficients for one set of applies."""

    def __init__(self, d, lams):
        self.d = d          # (ni, nj, nk) diagonal V/dt term
        self.lams = lams    # [(lam_minus, lam_plus)] per axis


def build_dadi_data(w, metrics, cfg, ref, dtinv, relax: float = 1.0):
    """Coefficients from the current (halo-filled) state. ``dtinv`` = V/dt
    per interior cell (the pseudo-time diagonal; for a pure smoother pass
    dtinv = radius sum / CFL)."""
    p = torch.clamp(pressure(w), min=1e-10)
    rads = list(spectral_radii(w, p, metrics, cfg.ls_precon_mach))
    if cfg.viscous:
        # augment with the viscous radii (interior only, edge-padded)
        rv = viscous_spectral_radii(w, metrics, cfg, ref)
        rads = [r + pad_like_numpy(v, 1, "edge") for r, v in zip(rads, rv)]
    lams = [_face_lambdas(r, ax) for ax, r in enumerate(rads)]
    return DadiData(d=dtinv, lams=[(relax * lm, relax * lp)
                                   for lm, lp in lams])


def dadi_apply(data: DadiData, v):
    """Approximate (D + A_i + A_j + A_k)^-1 v on one block.

    v: (ni, nj, nk, nv). Solve the i-factor, scale by D, solve the
    j-factor, scale by D, solve the k-factor."""
    z = v
    for axis in range(3):
        lm, lp = data.lams[axis]
        diag = data.d + 0.5 * (lm + lp)
        zl = tridiag_solve(torch.movedim(-0.5 * lm, axis, 0),
                           torch.movedim(diag, axis, 0),
                           torch.movedim(-0.5 * lp, axis, 0),
                           torch.movedim(z, axis, 0))
        z = torch.movedim(zl, 0, axis)
        if axis < 2:
            z = z * data.d[..., None]
    return z
