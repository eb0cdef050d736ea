"""Multigrid preconditioner for the ANK/NK/adjoint linear systems
(counterpart of adflow_tpu/solvers/amg.py).

Reference analogue: the aggregation AMG of src/solver/amg.F90 (``setupAMG``
:75 builds 2:1 structured-agglomeration Galerkin coarse operators from the
assembled first-order PC matrix; ``MGPreCon`` :712 runs the recursive
V-cycle), selected with ``ANKGlobalPreconditioner`` /
``NKGlobalPreconditioner`` / ``adjointGlobalPreconditioner`` = 'multigrid',
depth ``*AMGLevels`` and smoothing ``*AMGNSmooth``.

The first-order flux Jacobian is kept in its structured form, a 7-point
block stencil (5x5 mean-flow blocks and scalar turbulence rows) per mesh
block:

    A v = D v + sum_ax ( L_ax v[-1] + U_ax v[+1] )

built from the same exact flux Jacobians and scalar (or |A|
characteristic) splitting as the line PC (solvers/linpc.py). The stencil
apply is batched 5x5 products, the smoother the batched block-Thomas line
solve, and Galerkin coarsening with piecewise-constant interpolation is
even/odd slicing and pool sums, so every coarse operator is again a 7-point
block stencil.

The composite apply (the JAX package's design):
    pre-smooth  z  = S v                 S = the full line PC
    correction  z += P C (R (v - A z))   A = the fine first-order stencil,
                                         C = damped line sweeps on boosted
                                             Galerkin coarse levels
    post-smooth z += S (v - A z)
with each coarse diagonal inflated by ``boost`` times its own trace
magnitude. Blocks are preconditioned independently (block Jacobi across
mesh blocks, the reference's ASM with overlap 0 across processors).

Everything here is plain PyTorch on the solver's device; the PC is built
outside the Newton step and lagged, and no derivative is taken through it.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from adflow_torch.physics.fluxes import extended_face_areas, spectral_radii
from adflow_torch.physics.thermo import IMX, IMZ, IRHO, pressure
from adflow_torch.physics.timestep import viscous_spectral_radii
from adflow_torch.solvers.dadi import tridiag_solve
from adflow_torch.solvers.linpc import (
    _pad_edge, abs_flux_jacobians, block_tridiag_solve, build_line_pc,
    flux_jacobians, line_pc_apply, line_pc_apply_transposed)
from adflow_torch.solvers.multigrid import (
    _pool_sum as _pool, coarsen_factors, prolong_correction as _prolong)


@dataclasses.dataclass(frozen=True)
class StencilOp:
    """7-point block-stencil operator on one mesh block's interior."""

    D: torch.Tensor                # (ni,nj,nk,5,5)
    L: Tuple[torch.Tensor, ...]    # per axis (ni,nj,nk,5,5), row i couples i-1
    U: Tuple[torch.Tensor, ...]    # per axis, row i couples i+1
    Dt: Optional[torch.Tensor]     # (ni,nj,nk) turbulence scalar diagonal
    Lt: Optional[tuple]            # per axis (ni,nj,nk); shared over nt vars
    Ut: Optional[tuple]
    turb_scale: Optional[tuple] = None    # system rows carry turbResScale

    def _replace(self, **kw):
        return dataclasses.replace(self, **kw)


def build_stencil_jacobian(w, metrics, cfg, ref, dtinv,
                           kappa: float = 1.0) -> StencilOp:
    """First-order flux-Jacobian stencil of (V/dt + dR/dw) for one block.

    The same linearization family as ``linpc.build_line_pc``, assembled
    for all three axes with a single shared diagonal (the reference's
    setupStateResidualMatrix first-order PC, adjointUtils.F90:7).
    w: halo-padded filled state; dtinv: (ni,nj,nk) V/dt.
    """
    matrix_split = (cfg.discretization.startswith("upwind")
                    or "matrix" in cfg.discretization)
    p = torch.clamp(pressure(w), min=1e-10)
    rads = list(spectral_radii(w, p, metrics, cfg.ls_precon_mach))
    if cfg.viscous:
        rv = viscous_spectral_radii(w, metrics, cfg, ref)
        rads = [r + _pad_edge(4.0 * v) for r, v in zip(rads, rv)]
    rtot = (rads[0] + rads[1] + rads[2])[1:-1, 1:-1, 1:-1]
    nt = w.shape[-1] - 5
    eye = torch.eye(5, dtype=w.dtype, device=w.device)
    sE = list(extended_face_areas(metrics))

    if matrix_split:
        D = dtinv[..., None, None] * eye
    else:
        D = (dtinv + kappa * rtot)[..., None, None] * eye
    Dt = dtinv + kappa * rtot if nt > 0 else None

    Ls, Us, Lts, Uts = [], [], [], []
    for ax in range(3):
        lo = [slice(2, -2)] * 3
        hi = [slice(2, -2)] * 3
        lo[ax] = slice(1, -3)
        hi[ax] = slice(3, -1)
        w_m = w[tuple(lo)][..., :5]
        w_p = w[tuple(hi)][..., :5]

        fm = [slice(1, -1)] * 3
        fp = [slice(1, -1)] * 3
        fm[ax] = slice(1, -2)
        fp[ax] = slice(2, -1)
        s_m = sE[ax][tuple(fm)]
        s_p = sE[ax][tuple(fp)]

        r_ext = rads[ax]
        lo_r = [slice(1, -1)] * 3
        hi_r = [slice(1, -1)] * 3
        lo_r[ax] = slice(0, -2)
        hi_r[ax] = slice(2, None)
        r_c = r_ext[1:-1, 1:-1, 1:-1]
        lam_m = 0.5 * (r_ext[tuple(lo_r)] + r_c)
        lam_p = 0.5 * (r_ext[tuple(hi_r)] + r_c)

        A_m = flux_jacobians(w_m, s_m)
        A_p = flux_jacobians(w_p, s_p)
        if matrix_split:
            w_c = w[2:-2, 2:-2, 2:-2, :5]
            L = -0.5 * (A_m + abs_flux_jacobians(w_m, s_m))
            U = 0.5 * (A_p - abs_flux_jacobians(w_p, s_p))
            D = D + 0.5 * (abs_flux_jacobians(w_c, s_m)
                           + abs_flux_jacobians(w_c, s_p))
        else:
            L = -0.5 * (A_m + kappa * lam_m[..., None, None] * eye)
            U = 0.5 * (A_p - kappa * lam_p[..., None, None] * eye)
        Ls.append(L)
        Us.append(U)

        if nt > 0:
            q_m = torch.sum(w_m[..., IMX:IMZ + 1] * s_m, dim=-1) \
                / w_m[..., IRHO]
            q_p = torch.sum(w_p[..., IMX:IMZ + 1] * s_p, dim=-1) \
                / w_p[..., IRHO]
            Lts.append(-0.5 * (q_m + kappa * lam_m))
            Uts.append(0.5 * (q_p - kappa * lam_p))
    ts = cfg.turb_scales if (nt > 0 and cfg.rans) else None
    if ts is not None and all(s == 1.0 for s in ts):
        ts = None
    return StencilOp(D=D, L=tuple(Ls), U=tuple(Us), Dt=Dt,
                     Lt=tuple(Lts) or None, Ut=tuple(Uts) or None,
                     turb_scale=ts)


# ---------------------------------------------------------------------------
# stencil algebra
# ---------------------------------------------------------------------------

def _roll_zero(a, ax, shift):
    """Shift along ax by ``shift`` (+1: take a[i-1]), zero-filled."""
    out = torch.zeros_like(a)
    n = a.shape[ax]
    if shift == 1:
        out.narrow(ax, 1, n - 1).copy_(a.narrow(ax, 0, n - 1))
    else:
        out.narrow(ax, 0, n - 1).copy_(a.narrow(ax, 1, n - 1))
    return out


def _bmm(M, v):
    """(...,5,5) @ (...,5) batched."""
    return torch.einsum("...ij,...j->...i", M, v)


def stencil_apply(op: StencilOp, v):
    """A v for v: (ni,nj,nk,nw) (mean-flow and optional turbulence rows)."""
    vm = v[..., :5]
    out = _bmm(op.D, vm)
    for ax in range(3):
        out = out + _bmm(op.L[ax], _roll_zero(vm, ax, 1))
        out = out + _bmm(op.U[ax], _roll_zero(vm, ax, -1))
    if v.shape[-1] > 5 and op.Dt is not None:
        vt = v[..., 5:]
        ot = op.Dt[..., None] * vt
        for ax in range(3):
            ot = ot + op.Lt[ax][..., None] * _roll_zero(vt, ax, 1)
            ot = ot + op.Ut[ax][..., None] * _roll_zero(vt, ax, -1)
        out = torch.cat([out, ot], dim=-1)
    return out


def stencil_transpose(op: StencilOp) -> StencilOp:
    """A^T as a stencil: (A^T v)_i = D_i^T v_i + U_{i-1}^T v_{i-1}
    + L_{i+1}^T v_{i+1}, for the adjoint PC (Galerkin commutes with the
    transpose for R = P^T, so transposing each level is exact)."""
    LT, UT, LtT, UtT = [], [], [], []
    for ax in range(3):
        # the new L couples row i to i-1: U_{i-1}^T shifted down
        LT.append(_roll_zero(op.U[ax].transpose(-1, -2), ax, 1))
        UT.append(_roll_zero(op.L[ax].transpose(-1, -2), ax, -1))
        if op.Lt is not None:
            LtT.append(_roll_zero(op.Ut[ax], ax, 1))
            UtT.append(_roll_zero(op.Lt[ax], ax, -1))
    return StencilOp(D=op.D.transpose(-1, -2), L=tuple(LT), U=tuple(UT),
                     Dt=op.Dt, Lt=tuple(LtT) or None, Ut=tuple(UtT) or None,
                     turb_scale=op.turb_scale)


def _line_first(a, axis):
    return torch.movedim(a, axis, 0).contiguous()


def line_smooth(op: StencilOp, r, z, axis: int, damp: float = 1.0):
    """One damped line-Jacobi sweep: z + damp * T_ax^-1 (r - A z)."""
    resid = r - stencil_apply(op, z)
    dz = block_tridiag_solve(_line_first(op.L[axis], axis),
                             _line_first(op.D, axis),
                             _line_first(op.U[axis], axis),
                             _line_first(resid[..., :5], axis))
    dz = torch.movedim(dz, 0, axis)
    if r.shape[-1] > 5 and op.Dt is not None:
        dzt = tridiag_solve(_line_first(op.Lt[axis], axis),
                            _line_first(op.Dt, axis),
                            _line_first(op.Ut[axis], axis),
                            _line_first(resid[..., 5:], axis))
        dz = torch.cat([dz, torch.movedim(dzt, 0, axis)], dim=-1)
    return z + damp * dz


# ---------------------------------------------------------------------------
# Galerkin coarsening (piecewise-constant P, R = P^T: the pool sum and the
# prolongation of solvers/multigrid.py)
# ---------------------------------------------------------------------------

def _even(a, ax):
    idx = [slice(None)] * a.dim()
    idx[ax] = slice(0, None, 2)
    return a[tuple(idx)]


def _odd(a, ax):
    idx = [slice(None)] * a.dim()
    idx[ax] = slice(1, None, 2)
    return a[tuple(idx)]


def _at_even(like, ax, vals):
    """A zero tensor shaped like ``like`` holding ``vals`` at the even
    positions along ``ax``."""
    out = torch.zeros_like(like)
    idx = [slice(None)] * out.dim()
    idx[ax] = slice(0, None, 2)
    out[tuple(idx)] = vals
    return out


def coarsen_stencil(op: StencilOp, f) -> StencilOp:
    """Galerkin RAP with piecewise-constant interpolation: the coarse
    operator of a 7-point stencil under 2:1 (semi-)agglomeration is again
    a 7-point stencil. Per axis with factor 2 (cells 2I, 2I+1 -> I):
      - the intra-aggregate couplings U[2I] (2I->2I+1) and L[2I+1] join
        D_c;
      - the crossing couplings U[2I+1] -> U_c[I], L[2I] -> L_c[I];
    then everything pool-sums over the remaining (tangential) factors."""
    D_new, Dt_new = op.D, op.Dt
    Ls, Us = list(op.L), list(op.U)
    Lts = list(op.Lt) if op.Lt is not None else None
    Uts = list(op.Ut) if op.Ut is not None else None
    for ax in range(3):
        if f[ax] != 2:
            continue
        # both intra couplings sum into the same aggregate: add the pair
        # sum at the even position (the pool sum collects it)
        D_new = D_new + _at_even(op.D, ax, _even(op.U[ax], ax)
                                 + _odd(op.L[ax], ax))
        Us[ax] = _at_even(op.U[ax], ax, _odd(op.U[ax], ax))
        Ls[ax] = _at_even(op.L[ax], ax, _even(op.L[ax], ax))
        if Lts is not None:
            Dt_new = Dt_new + _at_even(op.Dt, ax, _even(op.Ut[ax], ax)
                                       + _odd(op.Lt[ax], ax))
            Uts[ax] = _at_even(op.Ut[ax], ax, _odd(op.Ut[ax], ax))
            Lts[ax] = _at_even(op.Lt[ax], ax, _even(op.Lt[ax], ax))
    return StencilOp(
        D=_pool(D_new, f),
        L=tuple(_pool(a, f) for a in Ls),
        U=tuple(_pool(a, f) for a in Us),
        Dt=_pool(Dt_new, f) if Dt_new is not None else None,
        Lt=tuple(_pool(a, f) for a in Lts) if Lts is not None else None,
        Ut=tuple(_pool(a, f) for a in Uts) if Uts is not None else None,
        turb_scale=op.turb_scale)


# ---------------------------------------------------------------------------
# the multigrid preconditioner: line-PC smoother + Galerkin coarse correction
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class AMGPCData:
    line: object        # LinePCData, the fine smoother
    ops: tuple          # StencilOp per level (0 = finest)
    factors: tuple      # (fi,fj,fk) between level l and l+1
    axis: int           # the coarse line smoother's primary sweep axis
    n_smooth: int       # sweeps per coarse level
    coarse_damp: float = 0.6
    transposed: bool = False


def _boost_diag(op: StencilOp, boost: float) -> StencilOp:
    """Inflate the diagonal by boost x |trace/5| (coarse regularization)."""
    if boost <= 0.0:
        return op
    tr = torch.diagonal(op.D, dim1=-2, dim2=-1).sum(-1)[..., None, None] / 5.0
    eye = torch.eye(5, dtype=op.D.dtype, device=op.D.device)
    return op._replace(
        D=op.D + boost * torch.abs(tr) * eye,
        Dt=None if op.Dt is None else op.Dt * (1.0 + boost))


def build_amg_pc(w, metrics, cfg, ref, dtinv, levels: int = 2,
                 n_smooth: int = 1, axes=(1, 0, 2), kappa: float = 0.25,
                 coarse_boost: float = 1.0, coarse_damp: float = 0.6,
                 transpose: bool = False) -> AMGPCData:
    """Build the composite PC for one block (setupAMG analogue).

    axes/kappa parametrize the fine line-PC smoother and the stencil used
    for the correction residuals (they approximate the same operator);
    transpose=True builds M for A^T (adjoint solves)."""
    lp = build_line_pc(w, metrics, cfg, ref, dtinv=dtinv, axes=axes,
                       kappa=kappa)
    op0 = build_stencil_jacobian(w, metrics, cfg, ref, dtinv, kappa)
    if transpose:
        op0 = stencil_transpose(op0)
    ops = [op0]
    factors = []
    cur = op0
    for _ in range(1, max(levels, 1)):
        f = coarsen_factors(cur.D.shape[:3])
        if all(fa == 1 for fa in f):
            break
        cur = _boost_diag(coarsen_stencil(cur, f), coarse_boost)
        ops.append(cur)
        factors.append(f)
    return AMGPCData(line=lp, ops=tuple(ops), factors=tuple(factors),
                     axis=(axes[0] if axes else 1),
                     n_smooth=max(int(n_smooth), 1),
                     coarse_damp=float(coarse_damp), transposed=transpose)


def amg_vcycle(data: AMGPCData, r, lev: int):
    """Damped line-sweep V-cycle on the boosted coarse hierarchy
    (lev >= 1; the fine level is the composite apply's)."""
    op = data.ops[lev]
    z = torch.zeros_like(r)
    ax = data.axis if r.shape[data.axis] > 1 else 0
    for _ in range(data.n_smooth):
        z = line_smooth(op, r, z, ax, data.coarse_damp)
    if lev == len(data.ops) - 1:
        for ax2 in (0, 2, data.axis):
            if r.shape[ax2] > 1:
                z = line_smooth(op, r, z, ax2, data.coarse_damp)
        return z
    f = data.factors[lev]
    r_c = _pool(r - stencil_apply(op, z), f)
    z = z + _prolong(amg_vcycle(data, r_c, lev + 1), f)
    for _ in range(data.n_smooth):
        z = line_smooth(op, r, z, ax, data.coarse_damp)
    return z


def amg_pc_apply(data: AMGPCData, v):
    """The composite preconditioner's M^-1 v on one block.

    turbResScale rows: forward system M = S T -> M^-1 v = T^-1 (v / S);
    transposed (adjoint) M^T = T^T S -> M^-T v = (T^-T v) / S. The stencil
    levels are unscaled, so the whole apply works in the unscaled residual
    space and the line PC skips its own scaling."""
    op0 = data.ops[0]
    inv = None
    if op0.turb_scale is not None and v.shape[-1] > 5:
        inv = torch.tensor((1.0,) * 5 + tuple(1.0 / s for s in
                                              op0.turb_scale),
                           dtype=v.dtype, device=v.device)
    if inv is not None and not data.transposed:
        v = v * inv
    lp = data.line
    if data.transposed:
        def smooth(u):
            return line_pc_apply_transposed(lp, u, skip_scale=True)
    else:
        def smooth(u):
            return line_pc_apply(lp, u, skip_scale=True)

    z = smooth(v)
    if len(data.ops) > 1:
        r1 = v - stencil_apply(op0, z)
        z = z + _prolong(amg_vcycle(data, _pool(r1, data.factors[0]), 1),
                         data.factors[0])
        z = z + smooth(v - stencil_apply(op0, z))
    if inv is not None and data.transposed:
        z = z * inv
    return z
