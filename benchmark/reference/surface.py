# Frozen copy of adflow_torch/physics/surface.py for the benchmark's reference, its
# imports made local.
"""Surface integration: forces, moments, cost functions (counterpart of
adflow_tpu/physics/surface.py).

Pressure force on a wall face: F += (p_face - pInf) * S_out, with S_out the
face area vector pointing out of the fluid. Viscous stress uses the same
face flux as the viscous residual. ``flow_through`` integrates the mass
flow and the mass- and area-averaged totals over inflow and outflow
planes. On overset meshes the wall faces over fringe and hole cells are
masked out (``patch_iblank_mask``), overlapping patches carry the overlap
weights and the zipper's gap triangles take their data face's pressure and
traction (overset/assembly.py); ``cperror2`` is the cp-target inverse-design
objective. The family-restricted functions (``ADFLOW.addFunction``)
integrate a subset of the patches (api/output.py).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from .mesh import (VISCOUS_WALL_BCS, WALL_BCS, BCType,
                                    MultiBlockMesh)
from .refstate import GAMMA, ReferenceState
from .thermo import IMX, IMZ, IRHO, pressure

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


def patch_iblank_mask(iblank_list, patch):
    """(T1, T2) weight of a wall patch's faces: 1 where the adjacent cell
    computes, 0 at overset fringe/hole wall cells (the simplified stand-in
    for the reference's zipper mesh, overset/zipperMesh.F90:18, which
    removes overlapped surface quads before integration)."""
    if iblank_list is None or iblank_list[patch.block] is None:
        return None
    ibp = torch.nn.functional.pad(iblank_list[patch.block],
                                  (0, 0, 2, 2, 2, 2, 2, 2), value=1.0)
    return ibp[patch.int_sl][..., 0]


def wall_viscous_tractions(w, m, cfg, ref, patch: WallPatch, extras=None,
                           cache=None):
    """Viscous traction (force-per-face 3-vector ON THE BODY) at a wall
    patch's boundary faces, from the same face flux as the viscous residual.
    Sign: df_v = -sign * (tau . S_axis). ``cache`` memoizes the per-(block,
    axis) face-flux sweep."""
    from .viscous import face_viscous_flux

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
                     cfg=None, iblank_list=None, extras_list=None,
                     patch_weights=None, cp_targets=None,
                     zipper=None) -> Dict[str, torch.Tensor]:
    """Integrated force + moment vectors (nondim), pressure and viscous
    parts, plus the center-of-force sums. Halos of w must be filled.
    ``iblank_list``: the topology's per-block compute masks (or None);
    ``patch_weights``: per-patch (T1, T2) face weights, the overlap
    deduplication of overset surfaces (``overlap_surface_weights``);
    ``zipper``: a ``ZipperGaps`` whose gap triangles take their data face's
    pressure and traction (reference zipperIntegrations.F90);
    ``cp_targets``: per-patch (T1, T2) target Cp or None, adding
    ``cperror2`` = sum (Cp - Cp_target)^2 dA (surfaceIntegrations.F90:527)."""
    like = w_list[0]
    kw = dict(dtype=like.dtype, device=like.device)
    force_p = torch.zeros(3, **kw)
    force_v = torch.zeros(3, **kw)
    moment = torch.zeros(3, **kw)
    cof = torch.zeros((3, 3), **kw)
    cof_lift = torch.zeros(3, **kw)
    cp_err2 = torch.zeros((), **kw)
    ld = torch.as_tensor(ref.lift_dir, **kw)
    xref = torch.as_tensor(ref.moment_ref, **kw)
    visc_cache = {}
    for ip, patch in enumerate(patches):
        w = w_list[patch.block]
        m = metrics_list[patch.block]
        s = (m.si, m.sj, m.sk)[patch.axis]
        s_out = patch.sign * s[patch.face_sl]          # out of the fluid
        mask = patch_iblank_mask(iblank_list, patch)
        pw = patch_weights[ip] if patch_weights is not None else None
        if pw is not None:
            pw = torch.as_tensor(pw, **kw)
            mask = pw if mask is None else mask * pw
        if mask is not None:
            s_out = s_out * mask[..., None]
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
            if mask is not None:
                dfv = dfv * mask[..., None]
            force_v = force_v + torch.sum(dfv, dim=(0, 1))
            moment = moment + torch.sum(
                torch.linalg.cross(xc - xref, dfv, dim=-1), dim=(0, 1))
            df = df + dfv
        cof = cof + torch.einsum("tki,tkj->ij", df, xc)
        cof_lift = cof_lift + torch.einsum("tk,tkj->j", df @ ld, xc)
        tgt = cp_targets[ip] if cp_targets is not None else None
        if tgt is not None:
            q = ref.q_inf
            cp = (p_face - ref.p_inf) / (torch.clamp(q, min=1e-30)
                                         if torch.is_tensor(q)
                                         else max(q, 1e-30))
            da = torch.linalg.norm(s_out, dim=-1)
            cp_err2 = cp_err2 + torch.sum(
                (cp - torch.as_tensor(tgt, **kw)) ** 2 * da)
    if zipper is not None and zipper.n_tris:
        f = _zipper_forces(w_list, metrics_list, patches, ref, cfg,
                           extras_list, zipper, visc_cache, ld, xref)
        force_p, force_v, moment = (force_p + f[0], force_v + f[1],
                                    moment + f[2])
        cof, cof_lift = cof + f[3], cof_lift + f[4]
    out = {"force_p": force_p, "force_v": force_v, "moment": moment,
           "cof": cof, "cof_lift": cof_lift}
    if cp_targets is not None:
        out["cperror2"] = cp_err2
    return out


def _zipper_forces(w_list, metrics_list, patches, ref, cfg, extras_list,
                   zipper, visc_cache, ld, xref):
    """The zipper gap triangles' (force_p, force_v, moment, cof, cof_lift):
    each triangle, oriented by its data face's outward normal, takes that
    face's pressure and its viscous traction per area."""
    import numpy as np

    like = w_list[0]
    kw = dict(dtype=like.dtype, device=like.device)
    force_p = torch.zeros(3, **kw)
    force_v = torch.zeros(3, **kw)
    moment = torch.zeros(3, **kw)
    cof = torch.zeros((3, 3), **kw)
    cof_lift = torch.zeros(3, **kw)
    for pi in np.unique(zipper.patch_idx):
        patch = patches[int(pi)]
        msel = zipper.patch_idx == pi
        w = w_list[patch.block]
        m = metrics_list[patch.block]
        s = (m.si, m.sj, m.sk)[patch.axis]
        s_out = patch.sign * s[patch.face_sl]   # unmasked: data faces
        p_face = 0.5 * (pressure(w[patch.int_sl])
                        + pressure(w[patch.ghost_sl]))
        idx = torch.as_tensor(zipper.face_flat[msel], dtype=torch.int64,
                              device=like.device)
        pg = p_face.reshape(-1)[idx]
        nf = s_out.reshape(-1, 3)[idx]
        sv = torch.as_tensor(zipper.svec[msel], **kw)
        sgn = torch.sign(torch.sum(sv * nf, dim=-1))
        sv = sv * torch.where(sgn == 0.0, torch.ones_like(sgn), sgn)[..., None]
        cen = torch.as_tensor(zipper.centroid[msel], **kw)
        dfp = (pg - ref.p_inf)[..., None] * sv
        force_p = force_p + torch.sum(dfp, dim=0)
        moment = moment + torch.sum(
            torch.linalg.cross(cen - xref, dfp, dim=-1), dim=0)
        df = dfp
        if patch.bc in VISCOUS_WALL_BCS and cfg is not None and cfg.viscous:
            ex = extras_list[patch.block] if extras_list is not None else None
            dfv_face = wall_viscous_tractions(w, m, cfg, ref, patch,
                                              extras=ex, cache=visc_cache)
            a_face = torch.linalg.norm(s_out, dim=-1).reshape(-1)[idx]
            a_tri = torch.linalg.norm(sv, dim=-1)
            tv = (dfv_face.reshape(-1, 3)[idx]
                  / torch.clamp(a_face, min=1e-30)[..., None]
                  * a_tri[..., None])
            force_v = force_v + torch.sum(tv, dim=0)
            moment = moment + torch.sum(
                torch.linalg.cross(cen - xref, tv, dim=-1), dim=0)
            df = df + tv
        cof = cof + torch.einsum("ti,tj->ij", df, cen)
        cof_lift = cof_lift + torch.einsum("t,tj->j", df @ ld, cen)
    return force_p, force_v, moment, cof, cof_lift


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
    for k in ("sepsensor", "cavitation", "cpmin_exact", "area",
              "cperror2"):
        if k in forces:
            out[k] = forces[k]
    # flow-through functions (mdot, mavgptot, ...); "area" becomes the
    # flow-through area, as in the JAX package
    for k, v in forces.items():
        if k.startswith("flow_") and k != "flow_fm":
            out[k[5:]] = v
    return out


SEP_SENSOR_SHARPNESS = 10.0
SEP_SENSOR_OFFSET = 0.0
CAVITATION_NUMBER = 1.4
CAVITATION_RHO = 100.0  # KS sharpness for cpmin aggregation


def wall_sensors(w_list, metrics_list, patches: Sequence[WallPatch],
                 ref: ReferenceState, iblank_list=None,
                 x_list=None) -> Dict[str, torch.Tensor]:
    """Separation sensor (KS-smoothed backflow area fraction), its centroid
    sums and the cavitation sensor (reference
    surfaceIntegrations.F90:406-520); overset fringe and hole faces
    masked out."""
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
        msk = patch_iblank_mask(iblank_list, patch)
        if msk is not None:
            da = da * msk
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


def flow_through(w_list, metrics_list, patches: Sequence[WallPatch],
                 ref: ReferenceState) -> Dict[str, torch.Tensor]:
    """Mass flow and mass- and area-averaged totals through inflow and
    outflow planes (reference surfaceIntegrations.F90 flowIntegrationFace:
    894). Positive mdot = flow into the domain (the reference's sign
    convention: the inward normal is positive at inflow families). Halos
    of w must be filled."""
    like = w_list[0]
    kw = dict(dtype=like.dtype, device=like.device)
    mdot, m_pt, m_tt, m_ps, m_mn, a_pt, a_ps, area = (
        torch.zeros((), **kw) for _ in range(8))
    g = GAMMA
    for patch in patches:
        w = w_list[patch.block]
        m = metrics_list[patch.block]
        s = (m.si, m.sj, m.sk)[patch.axis]
        s_out = patch.sign * s[patch.face_sl]
        da = torch.linalg.norm(s_out, dim=-1)
        wf = 0.5 * (w[patch.int_sl] + w[patch.ghost_sl])
        rho = wf[..., IRHO]
        v = wf[..., IMX:IMZ + 1] / rho[..., None]
        p = pressure(wf)
        c2 = g * p / rho
        mn = torch.linalg.norm(v, dim=-1) / torch.sqrt(c2)
        pt = p * (1.0 + 0.5 * (g - 1.0) * mn ** 2) ** (g / (g - 1.0))
        tt_ratio = (g * p / rho) * (1.0 + 0.5 * (g - 1.0) * mn ** 2)
        dm = -rho * torch.sum(v * s_out, dim=-1)     # + into the domain
        mdot = mdot + torch.sum(dm)
        m_pt = m_pt + torch.sum(dm * pt)
        m_tt = m_tt + torch.sum(dm * tt_ratio)
        m_ps = m_ps + torch.sum(dm * p)
        m_mn = m_mn + torch.sum(dm * mn)
        a_pt = a_pt + torch.sum(da * pt)
        a_ps = a_ps + torch.sum(da * p)
        area = area + torch.sum(da)
    safe_m = torch.where(torch.abs(mdot) > 1e-30, mdot,
                         torch.ones((), **kw))
    safe_a = torch.maximum(area, torch.full((), 1e-30, **kw))
    return {
        "flow_mdot": mdot,
        "flow_mavgptot": m_pt / safe_m,
        "flow_mavgttot": m_tt / safe_m,
        "flow_mavgps": m_ps / safe_m,
        "flow_mavgmn": m_mn / safe_m,
        "flow_aavgptot": a_pt / safe_a,
        "flow_aavgps": a_ps / safe_a,
        "flow_area": area,
    }
