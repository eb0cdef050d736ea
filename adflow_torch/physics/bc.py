"""Boundary conditions as halo (ghost-cell) fills (counterpart of
adflow_tpu/physics/bc.py).

Every physical BC is imposed by writing the two halo layers so the interior
stencils see the right face states. Subfaces are extended into tangential
halos where they touch block edges so corner halos get filled by sequential
application. ``apply_bcs`` copies the padded state once and writes the ghost
layers of the copy, so the caller's tensor is never modified. On a float32
CUDA state whose subfaces are all of the kinds ``ops/cuda_bc.py`` computes
(symmetry, static slip and no-slip walls without wall functions, far field,
extrapolation, no prescribed data), the pass is one CUDA launch a subface,
with a tangent of its own; every other pass is the plain per-op loop.

Every branch of the JAX package's ``_ghost_state`` is ported, with the
moving walls of ALE grid motion and the wall functions (Spalding's law).
Overset faces, like block-to-block ones, get no BC fill: their ghosts are
interpolated from donor blocks (overset/assembly.py). Where the JAX
package takes ``float()`` of the free stream (the mass-flow inflow, the
prescribed-state inflow with data and DOMAIN_INTERFACE_RHO), it cannot
trace them: under ``jax.jit`` or a derivative in the flow conditions
``float()`` of the traced free stream raises. The port keeps the free stream a tensor there: a ``float()`` under
``torch.func`` would drop its derivative silently, and a host copy would
stall the card at every fill. The values are the same.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from adflow_torch.core.mesh import BCType, Block
from adflow_torch.core.refstate import GAMMA, ReferenceState
from adflow_torch.ops import cuda_bc
from adflow_torch.physics.fluxes import _clip, _max, _min
from adflow_torch.physics.thermo import (
    IMX, IMZ, IRHO, IRHOE, ITURB, laminar_viscosity, pressure)
from adflow_torch.utils import trace

H = 2  # halo depth

# Width (fraction of local sound speed) of the smooth inflow/outflow blend in
# the far-field BC (same value as the JAX package).
FARFIELD_BLEND_WIDTH = 0.01


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


def _face_velocity(metrics, op: BCOp):
    """The ALE wall velocity over the (extended) subface, or None on a
    static mesh (reference BCData%uSlip from gridVelocitiesFineLevel)."""
    vf = (metrics.vfI, metrics.vfJ, metrics.vfK)[op.axis]
    return None if vf is None else _edge_pad2(vf[op.face_sl], op.pad)


def _wall_aux(metrics, op: BCOp, ref: ReferenceState):
    """Per-subface wall data for ``_ghost_state``: the wall velocity
    ``uwall`` of a moving wall, and with wall functions on a viscous wall
    the first-cell height ``dn`` = V1 / |S| (computeUtau). The JAX package
    computes ``dn`` on SST walls too, for a wall omega value it never
    uses; so it is computed here only where wall functions read it."""
    aux = {}
    if op.bc in (BCType.EULER_WALL, BCType.NS_WALL_ADIABATIC,
                 BCType.NS_WALL_ISOTHERMAL):
        uw = _face_velocity(metrics, op)
        if uw is not None:
            aux["uwall"] = uw
    if ref.wall_fn and op.bc in (BCType.NS_WALL_ADIABATIC,
                                 BCType.NS_WALL_ISOTHERMAL):
        s = (metrics.si, metrics.sj, metrics.sk)[op.axis]
        smag = _edge_pad2(torch.linalg.norm(s[op.face_sl], dim=-1), op.pad)
        aux["dn"] = metrics.vol[op.mirror[0]] / _max(smag, 1e-30)
    return aux


def _records(w, metrics, ref: ReferenceState, winf) -> bool:
    """Whether autograd records the ghost states: grad mode on and any of
    their inputs requiring grad (reverse mode, the adjoint's vjp in w, x or
    the flow conditions; forward mode and the solvers' paths do not)."""
    if not torch.is_grad_enabled():
        return False
    ts = (w, winf, metrics.si, metrics.sj, metrics.sk, *vars(ref).values())
    return any(isinstance(t, torch.Tensor) and t.requires_grad for t in ts)


def physical_ops(ops: Sequence[BCOp]) -> List[BCOp]:
    """The ops a BC pass fills: all but the block-to-block and overset
    faces, whose ghosts are exchanged or interpolated."""
    return [op for op in ops
            if op.bc is not BCType.B2B_MATCH and op.bc is not BCType.OVERSET]


def plain_bc_pass(w, metrics, ops: Sequence[BCOp], ref: ReferenceState,
                  winf, copy=False):
    """The per-op pass (counterpart of the JAX package's ``apply_bcs``):
    copies ``w`` once and writes each op's ghost layers into the copy in
    order. With ``copy``, each mirror layer is read as a copy: a view of
    ``w`` that the ghost state's backward saved would be invalidated by the
    next write into ``w``."""
    w = w.clone()
    for op in physical_ops(ops):
        nhat = _outward_normals(metrics, op)
        aux = _wall_aux(metrics, op, ref)
        for d in range(H):
            mirror = w[op.mirror[d]]
            w[op.ghost[d]] = _ghost_state(
                op, mirror.clone() if copy else mirror, nhat, ref, winf,
                aux=aux)
    return w


def _kernel_state(w) -> bool:
    """Whether ``w`` is a state the BC kernel computes in: float32 on
    CUDA."""
    return w.is_cuda and w.dtype == torch.float32


def _one_func_level(t) -> bool:
    """Whether ``t`` is a plain tensor or wrapped by one ``torch.func`` grad
    or jvp level, and no deeper: the kernel reads and writes the memory
    under that one wrapper (``cuda_bc._under``), and under a second level
    (a jvp of a jvp) or a vmap it would lose the outer level's part."""
    f = torch._C._functorch
    if f.is_functorch_wrapped_tensor(t):
        if not f.is_gradtrackingtensor(t):
            return False
        t = f.get_unwrapped(t)
    return not f.is_functorch_wrapped_tensor(t)


def _kernel_applies(w, metrics, ops: Sequence[BCOp], ref: ReferenceState,
                    winf) -> bool:
    """Whether the pass is what the BC kernel pass computes
    (``ops/cuda_bc.py``): a float32 state on CUDA; autograd not recording
    (``_records``: the adjoint's vjps stay on the plain pass); the state,
    the free stream and the face areas plain or under one ``torch.func``
    jvp level; every physical op of a kind of ``cuda_bc.KINDS``, with no
    face velocity on a wall and no wall functions on a viscous wall; no op
    with per-subface data."""
    if not _kernel_state(w) or _records(w, metrics, ref, winf):
        return False
    if not all(map(_one_func_level, (w, winf, metrics.siE, metrics.sjE,
                                     metrics.skE))):
        return False
    vf = (metrics.vfI, metrics.vfJ, metrics.vfK)
    walls = (BCType.EULER_WALL, BCType.NS_WALL_ADIABATIC)
    return (all(op.data is None for op in ops)
            and all(op.bc in cuda_bc.KINDS
                    and not (op.bc in walls and vf[op.axis] is not None)
                    and not (op.bc is BCType.NS_WALL_ADIABATIC
                             and ref.wall_fn)
                    for op in physical_ops(ops)))


@trace.spanned("halo.bc_pass")
def apply_bcs(w, metrics, ops: Sequence[BCOp], ref: ReferenceState, winf):
    """Fill all physical-BC halo layers of one block; returns a new tensor.

    Where the input is what the CUDA kernel computes (``_kernel_applies``)
    the pass is one launch a subface (``cuda_bc.fused_bc_pass``, its jvp
    the tangent kernel's); everywhere else it is the plain per-op pass
    (``plain_bc_pass``), which reads each mirror layer as a copy where
    autograd records."""
    if _kernel_applies(w, metrics, ops, ref, winf):
        return cuda_bc.fused_bc_pass(w, metrics, ops, ref, winf)
    return plain_bc_pass(w, metrics, ops, ref, winf,
                         copy=_records(w, metrics, ref, winf))


def _reflect_momentum(m, nhat):
    mn = torch.sum(m * nhat, dim=-1, keepdim=True)
    return m - 2.0 * mn * nhat


KARMAN_WF = 0.41
B_WF = 5.25


def spalding_utau(umag, d1, nu, n_iter: int = 30):
    """Friction velocity from Spalding's law of the wall,
    y+ = u+ + e^{-kB} (e^{k u+} - 1 - k u+ - (k u+)^2/2 - (k u+)^3/6),
    solved in u+ by a fixed number of Newton iterations on
    h(u+) = u+ y+(u+) - Re_d, Re_d = |u| d1 / nu (the reference's curve
    fits, turbCurveFits.F90; computeUtau, solverUtils.F90:2483)."""
    k = KARMAN_WF
    ekb = math.exp(-k * B_WF)
    umag = _max(umag, 1e-12)
    red = umag * _max(d1, 1e-30) / nu

    def spald(up):
        kup = _min(k * up, 50.0)
        return up + ekb * (torch.exp(kup) - 1.0 - kup - kup ** 2 / 2.0
                           - kup ** 3 / 6.0)

    def dspald(up):
        kup = _min(k * up, 50.0)
        return 1.0 + ekb * (k * torch.exp(kup) - k - k * kup
                            - k * kup ** 2 / 2.0)

    up = _min(torch.sqrt(red), 40.0)
    for _ in range(n_iter):
        h = up * spald(up) - red
        dh = spald(up) + up * dspald(up)
        up = _clip(up - h / dh, 1e-8, 200.0)
    return umag / up


def _wall_fn_ghost_momentum(wi, nhat, ref: ReferenceState, dn):
    """Ghost momentum of a viscous wall with wall functions: the tangential
    ghost velocity is scaled so the wall-face gradient delivers
    tau_w = rho u_tau^2 from Spalding's law; in the resolved limit beta ->
    1 recovers the no-slip mirror. Returns (momentum, u_tau, d1) for the
    SA wall anchor.

    The ghost scaling is calibrated against the face viscosity mu +
    0.5 mu_t with SA's mu_t whenever the state carries turbulence, so with
    SST it reads k as nuTilde, as the JAX package does. |u_t| is
    ``torch.linalg.norm``, whose derivative at a zero vector is 0 where
    the jvp of ``jnp.linalg.norm`` is NaN: at a cell with no tangential
    velocity the port's derivatives stay finite."""
    from adflow_torch.physics.sa import eddy_viscosity
    rho = wi[..., IRHO]
    v = wi[..., IMX:IMZ + 1] / rho[..., None]
    vn = torch.sum(v * nhat, dim=-1, keepdim=True) * nhat
    vt = v - vn
    vt_mag = torch.linalg.norm(vt, dim=-1)
    mu = laminar_viscosity(GAMMA * pressure(wi) / rho, ref.mu_inf,
                           ref.t_inf_dim)
    d1 = _max(0.5 * dn, 1e-12)
    ut = spalding_utau(vt_mag, d1, mu / rho)
    mu_face = mu + 0.5 * eddy_viscosity(wi, mu) if wi.shape[-1] > ITURB \
        else mu
    beta = rho * ut ** 2 * d1 / (mu_face * _max(vt_mag, 1e-12))
    beta = torch.maximum(beta, mu / mu_face)   # resolved: no-slip mirror
    vg = v - vn - 2.0 * beta[..., None] * vt - vn
    return rho[..., None] * vg, ut, d1


def _data_field(op: BCOp, key: str, default, like):
    """Prescribed BC datum: scalar or per-subface (T1, T2) array, edge-padded
    to the op's extended ghost extent; a flow direction ``dir`` may be one
    3-vector."""
    val = None if op.data is None else op.data.get(key)
    if val is None:
        return default
    if np.ndim(val) == 0:
        return float(val)
    arr = torch.as_tensor(np.asarray(val), dtype=like.dtype, device=like.device)
    if arr.dim() == 1 and key == "dir":
        return arr
    return _edge_pad2(arr, op.pad)


def _full(x, like):
    """A scalar, a 0-d tensor or a (T1, T2) array broadcast to the shape of
    ``like`` (``jnp.broadcast_to(jnp.asarray(x), like.shape)``)."""
    return torch.broadcast_to(
        torch.as_tensor(x, dtype=like.dtype, device=like.device), like.shape)


def _inflow_direction(op: BCOp, nhat, like):
    """The prescribed inflow direction, else the inward normal."""
    dvec = _data_field(op, "dir", None, like)
    return -nhat if dvec is None else torch.broadcast_to(dvec, nhat.shape)


def _with_turb(out, wi, turb):
    """Append the turbulence channels ``turb`` (a per-cell tensor, or the
    free stream's) when the state carries any."""
    if wi.shape[-1] <= ITURB:
        return out
    if turb.dim() == 1:
        turb = turb.expand(out.shape[:-1] + (wi.shape[-1] - ITURB,))
    return torch.cat([out, turb], dim=-1)


def _ghost_state(op: BCOp, wi, nhat, ref: ReferenceState, winf, aux=None):
    """Ghost-cell state for one halo layer given mirror-interior state wi;
    ``aux`` is ``_wall_aux``'s data of the subface."""
    bc = op.bc
    gamma = GAMMA
    uwall = aux.get("uwall") if aux else None

    if bc in (BCType.SYMMETRY, BCType.SYMMETRY_POLAR, BCType.EULER_WALL):
        # slip: mirror the momentum vector; rho, rhoE, turb unchanged. A
        # moving Euler wall mirrors the momentum relative to the wall
        m = wi[..., IMX:IMZ + 1]
        if bc is BCType.EULER_WALL and uwall is not None:
            mw = wi[..., IRHO:IRHO + 1] * uwall
            m = mw + _reflect_momentum(m - mw, nhat)
        else:
            m = _reflect_momentum(m, nhat)
        return torch.cat([wi[..., IRHO:IRHO + 1], m, wi[..., IRHOE:]],
                         dim=-1)

    if bc is BCType.NS_WALL_ADIABATIC:
        # no-slip: opposite velocity, same rho/energy; turb -> -interior.
        # A moving wall: ghost velocity 2 uwall - u, and the ghost energy
        # from the interior pressure (bcNSWallAdiabatic sets pp1 = pp2)
        wf_on = (ref.wall_fn and uwall is None and aux is not None
                 and "dn" in aux)
        if wf_on:
            mg, utau, d1 = _wall_fn_ghost_momentum(wi, nhat, ref, aux["dn"])
        else:
            mg = -wi[..., IMX:IMZ + 1]
        if uwall is not None:
            mg = mg + 2.0 * wi[..., IRHO:IRHO + 1] * uwall
            rhoe = (pressure(wi) / (gamma - 1.0) + 0.5 * torch.sum(
                mg * mg, dim=-1) / wi[..., IRHO])[..., None]
        else:
            rhoe = wi[..., IRHOE:IRHOE + 1]
        out = torch.cat([wi[..., IRHO:IRHO + 1], mg, rhoe], dim=-1)
        if wi.shape[-1] > ITURB:
            turb = -wi[..., ITURB:]
            if wf_on and wi.shape[-1] == ITURB + 1:
                # SA wall-function anchor: the ghost mirrors the linear
                # log-layer profile nuTilde = kappa u_tau y at -d1
                turb = (-KARMAN_WF * utau * d1)[..., None]
            out = torch.cat([out, turb], dim=-1)
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
        if uwall is not None:
            vg = vg + 2.0 * uwall
        rhoe = pi / (gamma - 1.0) + 0.5 * rho_g * torch.sum(vg * vg, dim=-1)
        out = torch.cat(
            [rho_g[..., None], rho_g[..., None] * vg, rhoe[..., None]], dim=-1)
        if wi.shape[-1] > ITURB:
            out = torch.cat([out, -wi[..., ITURB:]], dim=-1)
        return out

    if bc is BCType.FARFIELD:
        return _farfield_state(wi, nhat, winf, gamma)

    if bc in (BCType.SUBSONIC_OUTFLOW, BCType.MASS_BLEED_OUTFLOW,
              BCType.DOMAIN_INTERFACE_P):
        # prescribed static pressure, scalar or per-subface profile (bleed
        # outflow shares this handler, BCRoutines.F90:163-168;
        # DomainInterfaceP feeds an external p field, BCData.F90:2359)
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
        return _with_turb(out, wi, wi[..., ITURB:])

    if bc is BCType.DOMAIN_INTERFACE_RHOUVW:
        # prescribed density and velocity components (mass flow fixed,
        # BCData.F90:2381 domainInterfaceRhoUVW); static p from the interior
        pi = pressure(wi)
        v_f = winf[IMX:IMZ + 1] / winf[IRHO]
        rho_g = _full(_data_field(op, "rho", winf[IRHO], wi), pi)
        vx, vy, vz = (_full(_data_field(op, k, v_f[i], wi), pi)
                      for i, k in enumerate(("vx", "vy", "vz")))
        rhoe = pi / (gamma - 1.0) + 0.5 * rho_g * (vx**2 + vy**2 + vz**2)
        out = torch.stack([rho_g, rho_g * vx, rho_g * vy, rho_g * vz, rhoe],
                          dim=-1)
        return _with_turb(out, wi, winf[ITURB:])

    if bc in (BCType.SUBSONIC_INFLOW, BCType.MASS_BLEED_INFLOW,
              BCType.DOMAIN_INTERFACE_TOTAL):
        # DomainInterfaceTotal (BCData.F90:2414) prescribes Pt/Tt/flow
        # direction: the total-conditions branch below
        if (bc is BCType.MASS_BLEED_INFLOW
                or (bc is not BCType.DOMAIN_INTERFACE_TOTAL
                    and op.data is not None
                    and op.data.get("rho") is not None)):
            # mass-flow treatment (BCRoutines.F90:987): prescribed density
            # and velocity (magnitude along the inward normal or an explicit
            # direction); static pressure from the interior
            rho_spec = _data_field(op, "rho", winf[IRHO], wi)
            vmag = _data_field(op, "vmag", ref.mach, wi)
            d_in = _inflow_direction(op, nhat, wi)
            pi = pressure(wi)
            rho_g = _full(rho_spec, pi)
            vg = (vmag[..., None] * d_in if torch.is_tensor(vmag)
                  else vmag * d_in)
            rhoe = pi / (gamma - 1.0) + 0.5 * rho_g * torch.sum(
                vg * vg, dim=-1)
            out = torch.cat([rho_g[..., None], rho_g[..., None] * vg,
                             rhoe[..., None]], dim=-1)
            return _with_turb(out, wi, winf[ITURB:])
        # prescribed total state and direction; static p from the interior
        # (BCRoutines.F90:804 bcSubsonicInflow, total-conditions branch)
        mach = ref.mach
        pt_def = ref.p_inf * (1 + 0.5 * (gamma - 1) * mach ** 2) ** (
            gamma / (gamma - 1))
        tt_def = 1.0 + 0.5 * (gamma - 1) * mach ** 2
        pt = _data_field(op, "Pt", pt_def, wi)
        tt = _data_field(op, "Tt", tt_def, wi)
        d_in = _inflow_direction(op, nhat, wi)
        pi = pressure(wi)
        pi = torch.minimum(pi, _full(pt * 0.9999, pi))
        tg = tt * (pi / pt) ** ((gamma - 1.0) / gamma)
        v2 = torch.maximum(2.0 * (tt - tg) / (gamma - 1.0), _full(1e-30, pi))
        vmag = torch.sqrt(v2)   # floor > 0: sqrt'(0) = inf would NaN jvps
        rho_g = gamma * pi / tg
        vg = vmag[..., None] * d_in
        rhoe = pi / (gamma - 1.0) + 0.5 * rho_g * v2
        out = torch.cat([rho_g[..., None], rho_g[..., None] * vg,
                         rhoe[..., None]], dim=-1)
        return _with_turb(out, wi, winf[ITURB:])

    if bc in (BCType.SUPERSONIC_INFLOW, BCType.DOMAIN_INTERFACE_ALL):
        # prescribed full state (BCRoutines.F90:1411 bcSupersonicInflow;
        # DomainInterfaceAll shares it, BCData.F90:2282): per-subface
        # (rho, vx, vy, vz, p) arrays or scalars; the free stream when
        # nothing is prescribed
        if op.data is None or not any(
                op.data.get(k) is not None
                for k in ("rho", "vx", "vy", "vz", "P")):
            return winf.expand(wi.shape)
        rho_f = winf[IRHO]
        v_f = winf[IMX:IMZ + 1] / rho_f
        p_f = (GAMMA - 1.0) * (winf[IRHOE] - 0.5 * torch.sum(
            winf[IMX:IMZ + 1] ** 2) / rho_f)
        like = wi[..., IRHO]
        rho = _full(_data_field(op, "rho", rho_f, wi), like)
        vx, vy, vz = (_full(_data_field(op, k, v_f[i], wi), like)
                      for i, k in enumerate(("vx", "vy", "vz")))
        p = _full(_data_field(op, "P", p_f, wi), like)
        rhoe = p / (gamma - 1.0) + 0.5 * rho * (vx**2 + vy**2 + vz**2)
        out = torch.stack([rho, rho * vx, rho * vy, rho * vz, rhoe], dim=-1)
        return _with_turb(out, wi, winf[ITURB:])

    if bc is BCType.DOMAIN_INTERFACE_RHO:
        # prescribed density only; velocity and pressure from the interior
        # (BCData.F90:2448 domainInterfaceRho)
        pi = pressure(wi)
        rho_g = _full(_data_field(op, "rho", winf[IRHO], wi), pi)
        v = wi[..., IMX:IMZ + 1] / wi[..., IRHO:IRHO + 1]
        rhoe = pi / (gamma - 1.0) + 0.5 * rho_g * torch.sum(v * v, dim=-1)
        out = torch.cat([rho_g[..., None], rho_g[..., None] * v,
                         rhoe[..., None]], dim=-1)
        return _with_turb(out, wi, wi[..., ITURB:])

    if bc in (BCType.SUPERSONIC_OUTFLOW, BCType.EXTRAPOLATE):
        # zeroth-order extrapolation (the reference offers linear,
        # BCRoutines.F90:1479 bcExtrap)
        return wi

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
