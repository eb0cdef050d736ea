"""Boundary conditions as halo (ghost-cell) fills (counterpart of
adflow_tpu/physics/bc.py).

Every physical BC is imposed by writing the two halo layers so the interior
stencils see the right face states. Subfaces are extended into tangential
halos where they touch block edges so corner halos get filled by sequential
application. ``apply_bcs`` copies the padded state once and writes the ghost
layers of the copy, so the caller's tensor is never modified.

Ported branches: FARFIELD, SYMMETRY(_POLAR), EULER_WALL, NS_WALL_ADIABATIC,
NS_WALL_ISOTHERMAL and SUBSONIC_OUTFLOW, on static meshes without wall
functions. The remaining branches of the JAX package's ``_ghost_state`` are
ROADMAP.md queue 1 item 9 and raise when a mesh uses them.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from adflow_torch.core.mesh import BCType, Block
from adflow_torch.core.refstate import GAMMA, ReferenceState
from adflow_torch.physics.thermo import IMX, IMZ, IRHO, IRHOE, ITURB, pressure

H = 2  # halo depth

# Width (fraction of local sound speed) of the smooth inflow/outflow blend in
# the far-field BC (same value as the JAX package).
FARFIELD_BLEND_WIDTH = 0.01

SUPPORTED_BCS = (BCType.FARFIELD, BCType.SYMMETRY, BCType.SYMMETRY_POLAR,
                 BCType.EULER_WALL, BCType.NS_WALL_ADIABATIC,
                 BCType.NS_WALL_ISOTHERMAL, BCType.SUBSONIC_OUTFLOW,
                 BCType.B2B_MATCH)


@dataclasses.dataclass(frozen=True)
class BCOp:
    """One subface, compiled to static slices.

    ghost[d] / mirror[d]: index tuples into the halo-padded cell array
    selecting ghost layer d and its mirror interior layer. ``face_sl``:
    index into the si/sj/sk face-area array for the boundary faces under
    this subface; ``pad``: tangential edge-pad widths applied to the normal
    array so it matches the (extended) ghost extent. ``sign``: +1 if the
    stored face normal points outward (high faces), -1 otherwise.
    """

    bc: BCType
    axis: int
    is_high: bool
    ghost: Tuple[Tuple[Any, ...], ...]
    mirror: Tuple[Tuple[Any, ...], ...]
    face_sl: Tuple[Any, ...]
    pad: Tuple[Tuple[int, int], Tuple[int, int]]
    sign: float
    data: Optional[Dict[str, float]] = None


def _tangential_axes(axis: int) -> Tuple[int, int]:
    return tuple(a for a in range(3) if a != axis)  # ascending


def build_bc_ops(block: Block) -> List[BCOp]:
    ni, nj, nk = block.dims
    dims = (ni, nj, nk)
    ops: List[BCOp] = []
    for sf in block.bcs:
        if sf.bc not in SUPPORTED_BCS:
            raise NotImplementedError(
                f"BC {sf.bc.value!r} is not ported yet (ROADMAP.md queue 1 "
                f"item 9: the remaining BC branches of _ghost_state)")
        face = sf.face
        ax = face.axis
        t1, t2 = _tangential_axes(ax)
        rng = sf.rng if sf.rng is not None else ((0, dims[t1]), (0, dims[t2]))
        (a0, a1), (b0, b1) = rng
        ext = [[H if a0 == 0 else 0, H if a1 == dims[t1] else 0],
               [H if b0 == 0 else 0, H if b1 == dims[t2] else 0]]
        ghosts, mirrors = [], []
        for d in range(H):
            g = [None, None, None]
            m = [None, None, None]
            n = dims[ax]
            if face.is_high:
                g[ax] = H + n + d
                m[ax] = H + n - 1 - d
            else:
                g[ax] = H - 1 - d
                m[ax] = H + d
            g[t1] = m[t1] = slice(H + a0 - ext[0][0], H + a1 + ext[0][1])
            g[t2] = m[t2] = slice(H + b0 - ext[1][0], H + b1 + ext[1][1])
            ghosts.append(tuple(g))
            mirrors.append(tuple(m))
        fs = [None, None, None]
        fs[ax] = dims[ax] if face.is_high else 0
        fs[t1] = slice(a0, a1)
        fs[t2] = slice(b0, b1)
        ops.append(BCOp(
            bc=sf.bc, axis=ax, is_high=face.is_high,
            ghost=tuple(ghosts), mirror=tuple(mirrors),
            face_sl=tuple(fs),
            pad=((ext[0][0], ext[0][1]), (ext[1][0], ext[1][1])),
            sign=1.0 if face.is_high else -1.0,
            data=sf.data))
    return ops


def _edge_pad2(a, pad):
    """Edge-pad the two leading (tangential) axes by ``pad`` widths."""
    for ax, (lo, hi) in enumerate(pad):
        idx = np.pad(np.arange(a.shape[ax]), (lo, hi), mode="edge")
        a = torch.index_select(a, ax, torch.as_tensor(idx, device=a.device))
    return a


def _outward_normals(metrics, op: BCOp):
    """Unit outward normal over the (extended) subface, shape (T1, T2, 3)."""
    s = (metrics.si, metrics.sj, metrics.sk)[op.axis]
    n = _edge_pad2(op.sign * s[op.face_sl], op.pad)
    mag = torch.linalg.norm(n, dim=-1, keepdim=True)
    return n / torch.clamp(mag, min=1e-30)


def apply_bcs(w, metrics, ops: Sequence[BCOp], ref: ReferenceState, winf):
    """Fill all physical-BC halo layers of one block; returns a new tensor."""
    w = w.clone()
    for op in ops:
        if op.bc is BCType.B2B_MATCH:
            continue
        nhat = _outward_normals(metrics, op)
        for d in range(H):
            w[op.ghost[d]] = _ghost_state(op, w[op.mirror[d]], nhat, ref,
                                          winf)
    return w


def _reflect_momentum(wi, nhat):
    m = wi[..., IMX:IMZ + 1]
    mn = torch.sum(m * nhat, dim=-1, keepdim=True)
    return m - 2.0 * mn * nhat


def _data_field(op: BCOp, key: str, default, like):
    """Prescribed BC datum: scalar or per-subface (T1, T2) array, edge-padded
    to the op's extended ghost extent."""
    val = None if op.data is None else op.data.get(key)
    if val is None:
        return default
    if np.ndim(val) == 0:
        return float(val)
    arr = torch.as_tensor(np.asarray(val), dtype=like.dtype, device=like.device)
    return _edge_pad2(arr, op.pad)


def _ghost_state(op: BCOp, wi, nhat, ref: ReferenceState, winf):
    """Ghost-cell state for one halo layer given mirror-interior state wi."""
    bc = op.bc
    gamma = GAMMA

    if bc in (BCType.SYMMETRY, BCType.SYMMETRY_POLAR, BCType.EULER_WALL):
        # slip: mirror the momentum vector; rho, rhoE, turb unchanged
        return torch.cat([wi[..., IRHO:IRHO + 1], _reflect_momentum(wi, nhat),
                          wi[..., IRHOE:]], dim=-1)

    if bc is BCType.NS_WALL_ADIABATIC:
        # no-slip: opposite velocity, same rho/energy; turb -> -interior
        out = torch.cat([wi[..., IRHO:IRHO + 1], -wi[..., IMX:IMZ + 1],
                         wi[..., IRHOE:IRHOE + 1]], dim=-1)
        if wi.shape[-1] > ITURB:
            out = torch.cat([out, -wi[..., ITURB:]], dim=-1)
        return out

    if bc is BCType.NS_WALL_ISOTHERMAL:
        tw = _data_field(op, "T", None, wi)
        twall = (tw / ref.t_inf_dim) if tw is not None else 1.0
        pi = pressure(wi)
        ti = gamma * pi / wi[..., IRHO]
        tg = torch.maximum(2.0 * twall - ti,
                           torch.as_tensor(0.05 * twall, dtype=wi.dtype,
                                           device=wi.device))
        rho_g = gamma * pi / tg
        vg = -wi[..., IMX:IMZ + 1] / wi[..., IRHO:IRHO + 1]
        rhoe = pi / (gamma - 1.0) + 0.5 * rho_g * torch.sum(vg * vg, dim=-1)
        out = torch.cat(
            [rho_g[..., None], rho_g[..., None] * vg, rhoe[..., None]], dim=-1)
        if wi.shape[-1] > ITURB:
            out = torch.cat([out, -wi[..., ITURB:]], dim=-1)
        return out

    if bc is BCType.FARFIELD:
        return _farfield_state(wi, nhat, winf, gamma)

    if bc is BCType.SUBSONIC_OUTFLOW:
        p_spec = _data_field(op, "P", ref.p_inf, wi)
        pi = pressure(wi)
        pg = torch.maximum(2.0 * p_spec - pi,
                           torch.as_tensor(0.05 * p_spec, dtype=wi.dtype,
                                           device=wi.device))
        rho_g = wi[..., IRHO] * (pg / torch.clamp(pi, min=1e-12)) ** (
            1.0 / gamma)
        v = wi[..., IMX:IMZ + 1] / wi[..., IRHO:IRHO + 1]
        rhoe = pg / (gamma - 1.0) + 0.5 * rho_g * torch.sum(v * v, dim=-1)
        out = torch.cat(
            [rho_g[..., None], rho_g[..., None] * v, rhoe[..., None]], dim=-1)
        if wi.shape[-1] > ITURB:
            out = torch.cat([out, wi[..., ITURB:]], dim=-1)
        return out

    raise NotImplementedError(f"BC {bc} not implemented")


def _farfield_state(wi, nhat, winf, gamma):
    """Riemann-invariant characteristic far field (BCRoutines.F90:1282)."""
    rho_i = wi[..., IRHO]
    v_i = wi[..., IMX:IMZ + 1] / rho_i[..., None]
    p_i = pressure(wi)
    c_i = torch.sqrt(gamma * p_i / rho_i)
    un_i = torch.sum(v_i * nhat, dim=-1)

    rho_f = winf[IRHO]
    v_f = winf[IMX:IMZ + 1] / rho_f
    p_f = (gamma - 1.0) * (winf[IRHOE] - 0.5 * torch.sum(
        winf[IMX:IMZ + 1] ** 2) / rho_f)
    c_f = torch.sqrt(gamma * p_f / rho_f)
    un_f = torch.sum(v_f * nhat, dim=-1)

    gm1 = gamma - 1.0
    rplus = un_i + 2.0 * c_i / gm1     # leaves through the boundary
    rminus = un_f - 2.0 * c_f / gm1    # enters from outside

    # supersonic overrides
    rplus = torch.where(un_i < -c_i, un_f + 2.0 * c_f / gm1, rplus)
    rminus = torch.where(un_i > c_i, un_i - 2.0 * c_i / gm1, rminus)

    un_b = 0.5 * (rplus + rminus)
    c_b = torch.clamp(0.25 * gm1 * (rplus - rminus), min=1e-6)

    # smooth inflow/outflow blend over a few percent of the sound speed
    sig = 0.5 * (1.0 + torch.tanh(un_b / (FARFIELD_BLEND_WIDTH * c_b)))
    s_up = sig * (p_i / rho_i ** gamma) + (1.0 - sig) * (p_f / rho_f ** gamma)
    vt_i = v_i - un_i[..., None] * nhat
    vt_f = v_f - un_f[..., None] * nhat
    vt = sig[..., None] * vt_i + (1.0 - sig[..., None]) * vt_f

    rho_b = (c_b ** 2 / (gamma * s_up)) ** (1.0 / gm1)
    p_b = rho_b * c_b ** 2 / gamma
    v_b = vt + un_b[..., None] * nhat
    rhoe = p_b / gm1 + 0.5 * rho_b * torch.sum(v_b * v_b, dim=-1)
    out = torch.cat(
        [rho_b[..., None], rho_b[..., None] * v_b, rhoe[..., None]], dim=-1)
    if wi.shape[-1] > ITURB:
        turb = (sig[..., None] * wi[..., ITURB:]
                + (1.0 - sig[..., None]) * winf[ITURB:].expand_as(
                    wi[..., ITURB:]))
        out = torch.cat([out, turb], dim=-1)
    return out
