"""Scalar line solves (counterpart of adflow_tpu/solvers/dadi.py; only its
``tridiag_solve``, the turbulence line solve of the line preconditioner).

The JAX package runs the Thomas recurrence as two ``lax.scan``s. Here the
forward elimination is factored once (``tridiag_factor``: it depends only on
the coefficients), so a solve is one multiply-add per cell along the line in
each direction (``tridiag_solve_factored``). That changes the result by
round-off only. The DADI smoother itself is not ported (ROADMAP.md queue 1
item 10).
"""

from __future__ import annotations

import torch


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
