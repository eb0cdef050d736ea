"""Surface integration: forces, moments, cost functions (counterpart of
adflow_tpu/physics/surface.py).

Pressure force on a wall face: F += (p_face - pInf) * S_out, with S_out the
face area vector pointing out of the fluid. Viscous stress uses the same
face flux as the viscous residual. Overset weights, the zipper mesh,
cp-target inverse design and flow-through integration are not ported
(ROADMAP.md queue 1 items 11 and 13).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from adflow_torch.core.mesh import (VISCOUS_WALL_BCS, WALL_BCS, BCType,
                                    MultiBlockMesh)
from adflow_torch.core.refstate import ReferenceState
from adflow_torch.physics.thermo import IMX, IMZ, IRHO, pressure

# BC types whose patches the JAX package integrates as flow-through planes
FLOW_THROUGH_BCS = (BCType.SUBSONIC_INFLOW, BCType.SUBSONIC_OUTFLOW,
                    BCType.SUPERSONIC_INFLOW, BCType.SUPERSONIC_OUTFLOW,
                    BCType.MASS_BLEED_INFLOW, BCType.MASS_BLEED_OUTFLOW,
                    BCType.DOMAIN_INTERFACE_ALL,
                    BCType.DOMAIN_INTERFACE_P,
                    BCType.DOMAIN_INTERFACE_RHO,
                    BCType.DOMAIN_INTERFACE_RHOUVW,
                    BCType.DOMAIN_INTERFACE_TOTAL)


@dataclasses.dataclass(frozen=True)
class WallPatch:
    """Compiled wall subface for integration: slices into cell/face arrays."""

    block: int
    bc: BCType
    family: str
    axis: int
    sign: float
    face_sl: Tuple          # into si/sj/sk: boundary faces of the patch
    int_sl: Tuple           # first interior cell layer (padded coords)
    ghost_sl: Tuple         # first ghost layer
    fnode_sl: Tuple         # into x: the 4-node window of the patch faces


def build_wall_patches(mesh: MultiBlockMesh,
                       families: Optional[Sequence[str]] = None,
                       include: Tuple[BCType, ...] = WALL_BCS
                       ) -> List[WallPatch]:
    patches = []
    for bi, blk in enumerate(mesh.blocks):
        dims = blk.dims
        for sf in blk.bcs:
            if sf.bc not in include:
                continue
            if families is not None and sf.family not in families:
                continue
            ax = sf.face.axis
            t1, t2 = [a for a in range(3) if a != ax]
            rng = sf.rng or ((0, dims[t1]), (0, dims[t2]))
            (a0, a1), (b0, b1) = rng
            fs = [None] * 3
            fs[ax] = dims[ax] if sf.face.is_high else 0
            fs[t1], fs[t2] = slice(a0, a1), slice(b0, b1)
            isl = [None] * 3
            gsl = [None] * 3
            isl[ax] = 2 + dims[ax] - 1 if sf.face.is_high else 2
            gsl[ax] = 2 + dims[ax] if sf.face.is_high else 1
            isl[t1] = gsl[t1] = slice(2 + a0, 2 + a1)
            isl[t2] = gsl[t2] = slice(2 + b0, 2 + b1)
            nsl = [None] * 3
            nsl[ax] = dims[ax] if sf.face.is_high else 0
            nsl[t1], nsl[t2] = slice(a0, a1 + 1), slice(b0, b1 + 1)
            patches.append(WallPatch(
                block=bi, bc=sf.bc, family=sf.family, axis=ax,
                sign=1.0 if sf.face.is_high else -1.0,
                face_sl=tuple(fs), int_sl=tuple(isl), ghost_sl=tuple(gsl),
                fnode_sl=tuple(nsl)))
    return patches


def _patch_face_centers(x, patch: WallPatch):
    # x[fnode_sl] drops the face axis: the two in-face directions remain
    xs = x[patch.fnode_sl]

    def corner(d1, d2):
        return xs[d1:xs.shape[0] - 1 + d1, d2:xs.shape[1] - 1 + d2]

    return 0.25 * (corner(0, 0) + corner(1, 0) + corner(0, 1) + corner(1, 1))


def wall_viscous_tractions(w, m, cfg, ref, patch: WallPatch, extras=None,
                           cache=None):
    """Viscous traction (force-per-face 3-vector ON THE BODY) at a wall
    patch's boundary faces, from the same face flux as the viscous residual.
    Sign: df_v = -sign * (tau . S_axis). ``cache`` memoizes the per-(block,
    axis) face-flux sweep."""
    from adflow_torch.physics.viscous import face_viscous_flux

    key = (patch.block, patch.axis)
    if cache is not None and key in cache:
        fmom = cache[key]
    else:
        fmom, _fen = face_viscous_flux(w, pressure(w), m, cfg, ref,
                                       patch.axis, extras=extras)
        if cache is not None:
            cache[key] = fmom
    return -patch.sign * fmom[patch.face_sl]


def integrate_forces(w_list, x_list, metrics_list,
                     patches: Sequence[WallPatch], ref: ReferenceState,
                     cfg=None, extras_list=None) -> Dict[str, torch.Tensor]:
    """Integrated force + moment vectors (nondim), pressure and viscous
    parts, plus the center-of-force sums. Halos of w must be filled."""
    like = w_list[0]
    kw = dict(dtype=like.dtype, device=like.device)
    force_p = torch.zeros(3, **kw)
    force_v = torch.zeros(3, **kw)
    moment = torch.zeros(3, **kw)
    cof = torch.zeros((3, 3), **kw)
    cof_lift = torch.zeros(3, **kw)
    ld = torch.as_tensor(ref.lift_dir, **kw)
    xref = torch.as_tensor(ref.moment_ref, **kw)
    visc_cache = {}
    for patch in patches:
        w = w_list[patch.block]
        m = metrics_list[patch.block]
        s = (m.si, m.sj, m.sk)[patch.axis]
        s_out = patch.sign * s[patch.face_sl]          # out of the fluid
        p_face = 0.5 * (pressure(w[patch.int_sl]) + pressure(w[patch.ghost_sl]))
        dfp = (p_face - ref.p_inf)[..., None] * s_out
        xc = _patch_face_centers(x_list[patch.block], patch)
        force_p = force_p + torch.sum(dfp, dim=(0, 1))
        moment = moment + torch.sum(
            torch.linalg.cross(xc - xref, dfp, dim=-1), dim=(0, 1))
        df = dfp
        if patch.bc in VISCOUS_WALL_BCS and cfg is not None and cfg.viscous:
            ex = extras_list[patch.block] if extras_list is not None else None
            dfv = wall_viscous_tractions(w, m, cfg, ref, patch, extras=ex,
                                         cache=visc_cache)
            force_v = force_v + torch.sum(dfv, dim=(0, 1))
            moment = moment + torch.sum(
                torch.linalg.cross(xc - xref, dfv, dim=-1), dim=(0, 1))
            df = df + dfv
        cof = cof + torch.einsum("tki,tkj->ij", df, xc)
        cof_lift = cof_lift + torch.einsum("tk,tkj->j", df @ ld, xc)
    return {"force_p": force_p, "force_v": force_v, "moment": moment,
            "cof": cof, "cof_lift": cof_lift}


def cost_functions(forces: Dict[str, torch.Tensor], ref: ReferenceState
                   ) -> Dict[str, torch.Tensor]:
    """Map integrated vectors to the cost-function menu (names of the
    reference's pyADflow.py:6471-6556 map)."""
    fp = forces["force_p"]
    fv = forces["force_v"]
    kw = dict(dtype=fp.dtype, device=fp.device)
    qs = ref.q_inf * ref.area_ref
    pdim = ref.p_ref_dim
    fm = forces.get("flow_fm", torch.zeros(3, **kw))
    f = fp + fv + fm
    ld = torch.as_tensor(ref.lift_dir, **kw)
    dd = torch.as_tensor(ref.drag_dir, **kw)
    lift = f @ ld
    drag = f @ dd
    mom = forces["moment"] / (qs * ref.chord_ref)
    out = {
        "lift": lift * pdim, "drag": drag * pdim,
        "fx": f[0] * pdim, "fy": f[1] * pdim, "fz": f[2] * pdim,
        "mx": forces["moment"][0] * pdim,
        "my": forces["moment"][1] * pdim,
        "mz": forces["moment"][2] * pdim,
        "liftpressure": (fp @ ld) * pdim, "liftviscous": (fv @ ld) * pdim,
        "liftmomentum": (fm @ ld) * pdim,
        "dragpressure": (fp @ dd) * pdim, "dragviscous": (fv @ dd) * pdim,
        "dragmomentum": (fm @ dd) * pdim,
        "forcexpressure": fp[0] * pdim, "forceypressure": fp[1] * pdim,
        "forcezpressure": fp[2] * pdim,
        "forcexviscous": fv[0] * pdim, "forceyviscous": fv[1] * pdim,
        "forcezviscous": fv[2] * pdim,
        "forcexmomentum": fm[0] * pdim, "forceymomentum": fm[1] * pdim,
        "forcezmomentum": fm[2] * pdim,
        "cl": lift / qs, "cd": drag / qs,
        "clp": (fp @ ld) / qs, "clv": (fv @ ld) / qs,
        "clm": (fm @ ld) / qs,
        "cdp": (fp @ dd) / qs, "cdv": (fv @ dd) / qs,
        "cdm": (fm @ dd) / qs,
        "cfx": f[0] / qs, "cfy": f[1] / qs, "cfz": f[2] / qs,
        "cfxp": fp[0] / qs, "cfyp": fp[1] / qs, "cfzp": fp[2] / qs,
        "cfxv": fv[0] / qs, "cfyv": fv[1] / qs, "cfzv": fv[2] / qs,
        "cfxm": fm[0] / qs, "cfym": fm[1] / qs, "cfzm": fm[2] / qs,
        "cmx": mom[0], "cmy": mom[1], "cmz": mom[2],
    }
    if "cof" in forces:
        # per-component force centroid; zero when the component vanishes
        cof = forces["cof"]
        zero = torch.zeros((), **kw)
        for i, nm in enumerate("xyz"):
            on = torch.abs(f[i]) > 1e-30
            safe = torch.where(on, f[i], torch.ones((), **kw))
            for j, nj in enumerate("xyz"):
                out[f"cof{nm}{nj}"] = torch.where(on, cof[i, j] / safe, zero)
        on_l = torch.abs(lift) > 1e-30
        safe_l = torch.where(on_l, lift, torch.ones((), **kw))
        for j, nj in enumerate("xyz"):
            out[f"cofl{nj}"] = torch.where(
                on_l, forces["cof_lift"][j] / safe_l, zero)
        out["colx"], out["coly"], out["colz"] = (
            out["coflx"], out["cofly"], out["coflz"])
    if "sepavg" in forces:
        out["sepsensoravgx"] = forces["sepavg"][0]
        out["sepsensoravgy"] = forces["sepavg"][1]
        out["sepsensoravgz"] = forces["sepavg"][2]
    for k in ("sepsensor", "cavitation", "cpmin_exact", "area"):
        if k in forces:
            out[k] = forces[k]
    return out


SEP_SENSOR_SHARPNESS = 10.0
SEP_SENSOR_OFFSET = 0.0
CAVITATION_NUMBER = 1.4
CAVITATION_RHO = 100.0  # KS sharpness for cpmin aggregation


def wall_sensors(w_list, metrics_list, patches: Sequence[WallPatch],
                 ref: ReferenceState, x_list=None) -> Dict[str, torch.Tensor]:
    """Separation sensor (KS-smoothed backflow area fraction), its centroid
    sums and the cavitation sensor (reference
    surfaceIntegrations.F90:406-520)."""
    like = w_list[0]
    kw = dict(dtype=like.dtype, device=like.device)
    sep = torch.zeros((), **kw)
    sepavg = torch.zeros(3, **kw)
    cav = torch.zeros((), **kw)
    area = torch.zeros((), **kw)
    cp_ks = torch.zeros((), **kw)
    vhat_inf = torch.as_tensor(ref.vel_dir, **kw)
    for patch in patches:
        w = w_list[patch.block]
        m = metrics_list[patch.block]
        s = (m.si, m.sj, m.sk)[patch.axis]
        da = torch.linalg.norm(patch.sign * s[patch.face_sl], dim=-1)
        wi = w[patch.int_sl]
        v = wi[..., IMX:IMZ + 1] / wi[..., IRHO:IRHO + 1]
        vmag = torch.linalg.norm(v, dim=-1, keepdim=True)
        sdot = torch.sum(v / torch.clamp(vmag, min=1e-14) * vhat_inf, dim=-1)
        dsep = da / (1.0 + torch.exp(2.0 * SEP_SENSOR_SHARPNESS
                                     * (sdot - SEP_SENSOR_OFFSET)))
        sep = sep + torch.sum(dsep)
        if x_list is not None:
            xc = _patch_face_centers(x_list[patch.block], patch)
            sepavg = sepavg + torch.einsum("tk,tkj->j", dsep, xc)
        p_face = 0.5 * (pressure(wi) + pressure(w[patch.ghost_sl]))
        cp = (p_face - ref.p_inf) / max(ref.q_inf, 1e-30)
        cav = cav + torch.sum(
            da / (1.0 + torch.exp(-2.0 * SEP_SENSOR_SHARPNESS
                                  * (-cp - CAVITATION_NUMBER))))
        cp_ks = cp_ks + torch.sum(torch.exp(-CAVITATION_RHO * cp) * da)
        area = area + torch.sum(da)
    out = {"sepsensor": sep, "cavitation": cav, "area": area}
    if x_list is not None:
        out["sepavg"] = sepavg
    if patches:
        out["cpmin_exact"] = -torch.log(
            cp_ks / torch.clamp(area, min=1e-30)) / CAVITATION_RHO
    return out
