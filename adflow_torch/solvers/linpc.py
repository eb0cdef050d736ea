"""Block line-implicit preconditioner for the ANK/NK linear systems
(counterpart of adflow_tpu/solvers/linpc.py; reference analogue: the
first-order approximate Jacobian PC that the reference assembles into PETSc
with ASM+ILU, adjointUtils.F90:7).

    M_dir = D + A_dir,   A_dir = first-order spectral-radius-split flux
                          Jacobian coupling along one grid line,

solved exactly along each line with a block-Thomas recurrence; all other
cells and lines are batched. Off-diagonal blocks use the exact flux
Jacobian (``torch.func.jacfwd`` of the face flux) with the scalar
|A| ~ lambda I splitting. Several directions compose multiplicatively.

The JAX package runs each recurrence as two ``lax.scan``s over L, D and U.
Here the forward elimination is factored once when the PC is built
(``block_tridiag_factor``: it depends only on L, D and U), and ``LinePCData``
keeps the factors instead of L, D and U. An apply is then one batched
5x5 product per cell along the line in each direction, which changes the
result by round-off only.

The adjoint's transposed apply (``line_pc_apply_transposed``) uses the
same stored factors, transposed, with the sweeps in reverse order; the JAX
package factors the transposed blocks at every apply instead.

Upwind and matrix-dissipation discretizations take the characteristic
split instead of the scalar one (``build_line_pc``), with |A_roe| blocks
from ``abs_flux_jacobians``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F

from adflow_torch.core.refstate import GAMMA
from adflow_torch.physics.fluxes import extended_face_areas, spectral_radii
from adflow_torch.physics.thermo import IMX, IMZ, IRHO, IRHOE, pressure
from adflow_torch.physics.timestep import viscous_spectral_radii
from adflow_torch.physics.upwind import roe_abs_jacobian_apply
from adflow_torch.solvers.dadi import (
    tridiag_factor, tridiag_solve_factored, tridiag_solve_factored_transposed)


def _euler_flux_single(w5, svec):
    """F(w).S for one cell's 5-vector (helper for jacfwd)."""
    rho = w5[IRHO]
    m = w5[IMX:IMZ + 1]
    ke = 0.5 * torch.sum(m * m) / rho
    p = (GAMMA - 1.0) * (w5[IRHOE] - ke)
    q = torch.dot(m, svec) / rho
    return torch.cat([(rho * q)[None], m * q + p * svec,
                      ((w5[IRHOE] + p) * q)[None]])


_flux_jac = torch.func.vmap(torch.func.jacfwd(_euler_flux_single))


def flux_jacobians(w5_cells, svecs):
    """Batched exact A(w).S (…,5,5) via forward-mode AD, in the dtype of
    ``w5_cells`` (under ``vmap(jacfwd)`` a 0-dim float32 tensor times a
    Python float comes out float64)."""
    flat_w = w5_cells.reshape(-1, 5)
    flat_s = torch.broadcast_to(
        svecs, w5_cells.shape[:-1] + (3,)).reshape(-1, 3)
    return _flux_jac(flat_w, flat_s).reshape(
        w5_cells.shape[:-1] + (5, 5)).to(w5_cells.dtype)


def _prim_from_cons(w5):
    """[rho, u, v, w, p] from conservative 5-vectors (trailing axis), the
    pressure floored at 1e-10."""
    rho = w5[..., 0:1]
    vel = w5[..., 1:4] / rho
    ke = 0.5 * torch.sum(w5[..., 1:4] * vel, dim=-1, keepdim=True)
    p = (GAMMA - 1.0) * (w5[..., 4:5] - ke)
    return torch.cat([rho, vel, torch.maximum(
        p, torch.as_tensor(1e-10, dtype=p.dtype, device=p.device))], dim=-1)


def abs_flux_jacobians(w5_cells, svecs):
    """Batched |A_roe(w)|.S (…,5,5) from conservative states: the linear
    map of the matrix-dissipation / Roe splitting
    (physics/upwind.py roe_abs_jacobian_apply with qL = qR, its eigenvalue
    floors included). The JAX package takes ``vmap(jacfwd)`` of the apply
    at dw = 0; the apply is linear in dw, so here it is evaluated on the
    five unit vectors at once, the same operations as the forward-mode
    tangents, in the dtype of ``w5_cells``."""
    batch = w5_cells.shape[:-1] + (5,)
    q = _prim_from_cons(w5_cells)[..., None, :].expand(batch + (5,))
    s = torch.broadcast_to(svecs[..., None, :], batch + (3,))
    eye = torch.eye(5, dtype=w5_cells.dtype, device=w5_cells.device)
    # row k of the apply on eye is column k of the matrix
    return roe_abs_jacobian_apply(q, q, s, eye).transpose(-1, -2)


def solve_small(A, B):
    """Batched dense solve for tiny blocks by unrolled Gauss-Jordan
    elimination without pivoting, the JAX package's algorithm step for step
    (the PC blocks are diagonally dominant by construction; the pivot gets a
    sign-preserving floor as a guard).

    A: (..., n, n); B: (..., n) or (..., n, k). Returns A^-1 B.
    """
    n = A.shape[-1]
    b_vec = B.dim() == A.dim() - 1
    if b_vec:
        B = B[..., None]
    M = torch.cat([A, B], dim=-1)
    rows = torch.arange(n, device=A.device)
    tiny = torch.finfo(A.dtype).tiny
    for i in range(n):
        piv = M[..., i, i:i + 1]
        piv = torch.where(torch.abs(piv) < tiny,
                          torch.where(piv < 0, -tiny, tiny), piv)
        row = M[..., i, :] / piv
        factor = torch.where(rows != i, M[..., :, i], 0.0)
        M = M - factor[..., None] * row[..., None, :]
        M[..., i, :] = row
    X = M[..., n:]
    return X[..., 0] if b_vec else X


def block_tridiag_factor(L, D, U):
    """Forward-elimination factors of the block-tridiagonal systems along
    axis 0: L/D/U (n, ..., b, b) block rows (L[0], U[-1] ignored).

    Returns (G, Dinv, Cp), each (n, ..., b, b), with denom_c = D_c - L_c
    Cp_{c-1}, Cp_c = denom_c^-1 U_c (as the JAX package computes it),
    Dinv_c = denom_c^-1 and G_c = denom_c^-1 L_c, so that the eliminated
    right-hand side is d_c = Dinv_c r_c - G_c d_{c-1}."""
    n, b = D.shape[0], D.shape[-1]
    G, Dinv, Cp = (torch.empty_like(D) for _ in range(3))
    eye = torch.eye(b, dtype=D.dtype, device=D.device).expand(D[0].shape)
    cp_prev = torch.zeros_like(D[0])
    for c in range(n):
        denom = D[c] - L[c] @ cp_prev
        X = solve_small(denom, torch.cat([U[c], L[c], eye], dim=-1))
        Cp[c], G[c], Dinv[c] = X[..., :b], X[..., b:2 * b], X[..., 2 * b:]
        cp_prev = Cp[c]
    return G, Dinv, Cp


def block_tridiag_solve_factored(factors, rhs):
    """Solve with the factors of ``block_tridiag_factor``; rhs (n, ..., b)."""
    G, Dinv, Cp = factors
    n, b = rhs.shape[0], rhs.shape[-1]
    nb = math.prod(rhs.shape[1:-1])
    G, Dinv, Cp = (a.reshape(n, nb, b, b) for a in (G, Dinv, Cp))
    x = Dinv @ rhs.reshape(n, nb, b, 1)
    for c in range(1, n):
        x[c].baddbmm_(G[c], x[c - 1], alpha=-1.0)
    for c in range(n - 2, -1, -1):
        x[c].baddbmm_(Cp[c], x[c + 1], alpha=-1.0)
    return x.reshape(rhs.shape)


def block_tridiag_solve_factored_transposed(factors, rhs):
    """Solve the transposed systems, T^T x = rhs, with the factors of T by
    ``block_tridiag_factor``; rhs (n, ..., b).

    T = Dm (I + N_G) U_Cp, with Dm the block diagonal of denom_c, N_G the
    block subdiagonal of G and U_Cp the unit block upper bidiagonal of Cp.
    So T^-T = Dinv^T (I + N_G)^-T U_Cp^-T: a forward sweep with Cp^T, a
    backward sweep with G^T, then Dinv^T a cell."""
    G, Dinv, Cp = factors
    n, b = rhs.shape[0], rhs.shape[-1]
    nb = math.prod(rhs.shape[1:-1])
    G, Dinv, Cp = (a.reshape(n, nb, b, b).transpose(-1, -2)
                   for a in (G, Dinv, Cp))
    x = rhs.reshape(n, nb, b, 1).clone()
    for c in range(1, n):
        x[c].baddbmm_(Cp[c - 1], x[c - 1], alpha=-1.0)
    for c in range(n - 2, -1, -1):
        x[c].baddbmm_(G[c + 1], x[c + 1], alpha=-1.0)
    return (Dinv @ x).reshape(rhs.shape)


def block_tridiag_solve(L, D, U, rhs):
    """Block-Thomas along axis 0.

    L/D/U: (n, ..., b, b) block rows (L[0], U[-1] ignored); rhs (n, ..., b).
    """
    return block_tridiag_solve_factored(block_tridiag_factor(L, D, U), rhs)


@dataclasses.dataclass(frozen=True)
class LinePCData:
    """Frozen per-block PC operators: for each sweep direction the factors
    of the block tridiagonal (L, D, U) in line-first axis order, and of the
    turbulence scalar tridiagonal (lt, dt, ut) when nw > 5. Built once and
    reused across Newton steps (the reference's Jacobian lag,
    NKJacobianLag/ANKJacobianLag, NKSolvers.F90:372)."""

    axes: tuple
    mean: list      # [(G, Dinv, Cp)] per axis, (n_ax, other..., 5, 5)
    turb: list      # [(g, denom, cp)] per axis, (n_ax, other...), or None
    dscalar: torch.Tensor  # (ni,nj,nk) full diagonal for inter-factor scaling
    # per-turb-variable turbResScale: the system's turbulence rows are
    # scaled by s, so PC = s*T and PC^-1 v = T^-1 (v/s)
    turb_scale: Optional[tuple] = None


def line_pc_data(axes, mean, turb, dscalar, turb_scale=None) -> LinePCData:
    """``LinePCData`` from the unfactored operators: ``mean`` a list of
    (L, D, U) and ``turb`` a list of (lt, dt, ut) or None, per axis."""
    return LinePCData(
        axes=tuple(axes),
        mean=[block_tridiag_factor(*ops) for ops in mean],
        turb=[None if t is None else tridiag_factor(*t) for t in turb],
        dscalar=dscalar, turb_scale=turb_scale)


def _pad_edge(a):
    """(n0, n1, n2) -> (n0+2, n1+2, n2+2), edge values replicated."""
    return F.pad(a[None, None], (1, 1, 1, 1, 1, 1), mode="replicate")[0, 0]


def build_line_pc(w, metrics, cfg, ref, dtinv, axes=(1,),
                  coupling: float = 1.0, kappa: float = 1.0) -> LinePCData:
    """Build PC data for one block.

    w: halo-padded state (filled); dtinv: (ni,nj,nk) V/dt diagonal.
    axes: sweep directions. kappa scales the scalar-|A| part of the
    splitting (A +- kappa*lambda I).

    Upwind and matrix-dissipation discretizations take the characteristic
    split instead: their physical dissipation of the entropy and shear rows
    is |u_n|, not |u_n|+c, which the scalar lambda*I split over-dissipates
    (GMRES stalls near 0.3 relative on the matrix-dissipation NACA0012 ANK
    solve, as the JAX package notes). L = -0.5(A_m + |A_m|), U = 0.5(A_p -
    |A_p|) and a full 5x5 diagonal D = (V/dt + kappa * cross radii) I +
    0.5(|A_c,m| + |A_c,p|), the first-order Roe line Jacobian (reference:
    setupStateResidualMatrix, adjointUtils.F90:7).
    """
    matrix_split = (cfg.discretization.startswith("upwind")
                    or "matrix" in cfg.discretization)
    p = torch.clamp(pressure(w), min=1e-10)
    rI, rJ, rK = spectral_radii(w, p, metrics, cfg.ls_precon_mach)
    rads = [rI, rJ, rK]
    if cfg.viscous:
        rv = viscous_spectral_radii(w, metrics, cfg, ref)
        rads = [r + _pad_edge(4.0 * v) for r, v in zip(rads, rv)]
    # total diagonal: V/dt + sum over all 6 faces of 0.5*kappa*lambda_face
    rtot = (rads[0] + rads[1] + rads[2])[1:-1, 1:-1, 1:-1]
    dscalar = dtinv + kappa * rtot
    nw = w.shape[-1]
    eye = torch.eye(5, dtype=w.dtype, device=w.device)
    sE = list(extended_face_areas(metrics))

    mean_ops = []
    turb_ops = []
    for ax in axes:
        # neighbour states along ax: cells c-1 and c+1
        lo = [slice(2, -2)] * 3
        hi = [slice(2, -2)] * 3
        lo[ax] = slice(1, -3)
        hi[ax] = slice(3, -1)
        w_m = w[tuple(lo)][..., :5]
        w_p = w[tuple(hi)][..., :5]

        # face areas on the extended grid: the minus face of cell c is at
        # extended index c+1, the plus face at c+2
        fm = [slice(1, -1)] * 3
        fp = [slice(1, -1)] * 3
        fm[ax] = slice(1, -2)
        fp[ax] = slice(2, -1)
        s_m = sE[ax][tuple(fm)]
        s_p = sE[ax][tuple(fp)]

        # face spectral radii: mean of adjacent cell radii (extended grid)
        r_ext = rads[ax]
        lo_r = [slice(1, -1)] * 3
        hi_r = [slice(1, -1)] * 3
        ce_r = [slice(1, -1)] * 3
        lo_r[ax] = slice(0, -2)
        hi_r[ax] = slice(2, None)
        lam_m = 0.5 * (r_ext[tuple(lo_r)] + r_ext[tuple(ce_r)])
        lam_p = 0.5 * (r_ext[tuple(hi_r)] + r_ext[tuple(ce_r)])

        A_m = flux_jacobians(w_m, s_m)
        A_p = flux_jacobians(w_p, s_p)
        if matrix_split:
            w_c = w[2:-2, 2:-2, 2:-2, :5]
            L = -0.5 * coupling * (A_m + abs_flux_jacobians(w_m, s_m))
            U = 0.5 * coupling * (A_p - abs_flux_jacobians(w_p, s_p))
            # pseudo-time + the scalar radii of the two cross directions +
            # the sweep direction's matrix |A| halves
            r_cross = rtot - rads[ax][1:-1, 1:-1, 1:-1]
            D = ((dtinv + kappa * r_cross)[..., None, None] * eye
                 + 0.5 * (abs_flux_jacobians(w_c, s_m)
                          + abs_flux_jacobians(w_c, s_p)))
        else:
            L = -0.5 * coupling * (A_m + kappa * lam_m[..., None, None] * eye)
            U = 0.5 * coupling * (A_p - kappa * lam_p[..., None, None] * eye)
            D = dscalar[..., None, None] * eye
        mean_ops.append(tuple(torch.movedim(a, ax, 0).contiguous()
                              for a in (L, D, U)))

        if nw > 5:
            # scalar advection-diffusion model for turbulence variables
            q_m = torch.sum(w_m[..., IMX:IMZ + 1] * s_m, dim=-1) / w_m[..., IRHO]
            q_p = torch.sum(w_p[..., IMX:IMZ + 1] * s_p, dim=-1) / w_p[..., IRHO]
            lt = -0.5 * coupling * (q_m + kappa * lam_m)
            ut = 0.5 * coupling * (q_p - kappa * lam_p)
            turb_ops.append(tuple(torch.movedim(a, ax, 0).contiguous()
                                  for a in (lt, dscalar, ut)))
        else:
            turb_ops.append(None)

    ts = cfg.turb_scales if (nw > 5 and cfg.rans) else None
    if ts is not None and all(s == 1.0 for s in ts):
        ts = None
    return line_pc_data(axes, mean_ops, turb_ops, dscalar, ts)


def _turb_unscale(data: LinePCData, like):
    """(nw,) row factors S^-1: 1 on the mean flow, 1/turbResScale on the
    turbulence rows."""
    inv = tuple(1.0 / s for s in data.turb_scale)
    return torch.tensor((1.0,) * 5 + inv, dtype=like.dtype,
                        device=like.device)


def line_pc_apply(data: LinePCData, v, skip_scale: bool = False):
    """Apply M^-1 v on one block, v: (ni,nj,nk,nw).

    Multiple axes compose as an approximate factorization
    M = (D+A_1) D^-1 (D+A_2) D^-1 ... with the full diagonal D in every
    factor.

    skip_scale: the caller works in the unscaled (physical) residual space
    and handles the turbResScale rows itself (solvers/amg.py)."""
    z = v
    if (not skip_scale and data.turb_scale is not None
            and v.shape[-1] > 5):
        # PC = S*T on the scaled turbulence rows: un-scale the input once,
        # then apply the unscaled factors
        z = z * _turb_unscale(data, v)
    for i, ax in enumerate(data.axes):
        if i > 0:
            z = z * data.dscalar[..., None]
        zb = torch.movedim(z, ax, 0)
        zl = block_tridiag_solve_factored(data.mean[i], zb[..., :5])
        if z.shape[-1] > 5 and data.turb[i] is not None:
            zt = tridiag_solve_factored(data.turb[i], zb[..., 5:])
            zl = torch.cat([zl, zt], dim=-1)
        z = torch.movedim(zl, 0, ax)
    return z


def line_pc_apply_transposed(data: LinePCData, v, skip_scale: bool = False):
    """Apply M^-T v on one block, v: (ni,nj,nk,nw) (the adjoint's PC).

    M^-1 = T_n^-1 D ... D T_1^-1 S^-1 (``line_pc_apply``), so M^-T =
    S^-1 T_1^-T D ... D T_n^-T: the transposed line solves in reverse
    order of the axes, each from the transposes of the stored factors
    (``block_tridiag_solve_factored_transposed``,
    ``dadi.tridiag_solve_factored_transposed``), and the turbulence rows'
    un-scale after the solves (unless ``skip_scale``, as in
    ``line_pc_apply``)."""
    z = v
    for i in reversed(range(len(data.axes))):
        ax = data.axes[i]
        zb = torch.movedim(z, ax, 0)
        zl = block_tridiag_solve_factored_transposed(data.mean[i],
                                                     zb[..., :5])
        if z.shape[-1] > 5 and data.turb[i] is not None:
            zt = tridiag_solve_factored_transposed(data.turb[i], zb[..., 5:])
            zl = torch.cat([zl, zt], dim=-1)
        z = torch.movedim(zl, 0, ax)
        if i > 0:
            z = z * data.dscalar[..., None]
    if (not skip_scale and data.turb_scale is not None
            and z.shape[-1] > 5):
        z = z * _turb_unscale(data, z)
    return z
