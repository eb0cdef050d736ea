"""User-defined integration surfaces (counterpart of
adflow_tpu/physics/usersurf.py).

Reference analogue: ``addIntegrationSurface`` (pyADflow.py:780) and
src/solver/userSurfaceIntegrations.F90: an arbitrary triangulated surface
placed inside the flow domain (an engine-inlet plane, a nozzle cross
section) on which mass flow and mass-averaged totals are integrated.

The element -> cell association is a host precompute (a cKDTree candidate
search and trilinear inversion in the dual cell-centre brick, the machinery
of the overset donors, overset/assembly.py) giving a static gather table;
the integral is one gather and a few reductions in torch, out of place, so
user-surface functions are adjoint objectives.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np
import torch

from adflow_torch.core.mesh import MultiBlockMesh
from adflow_torch.core.refstate import GAMMA, ReferenceState
from adflow_torch.physics.thermo import IMX, IMZ, IRHO, pressure


@dataclasses.dataclass(frozen=True)
class UserIntegrationSurface:
    """Static interpolation/integration tables for one surface."""

    family: str
    is_inflow: bool
    pts: np.ndarray                 # (np, 3) original vertices
    conn: np.ndarray                # (ne, 3) triangles (quads split)
    # per-triangle state interpolation: donors from block `blk`'s interior
    # cell-center field, 8 flat indices + trilinear weights
    blk: np.ndarray                 # (ne,)
    gather_flat: np.ndarray         # (8, ne) flat into (ni, nj, nk)
    weights: np.ndarray             # (8, ne)
    svec: np.ndarray                # (ne, 3) triangle area vectors
    n_orphans: int = 0              # elements outside every block


def triangulate(pts: np.ndarray, conn: np.ndarray) -> np.ndarray:
    """Split quads into triangles; pass triangles through."""
    conn = np.asarray(conn, np.int64)
    if conn.shape[1] == 3:
        return conn
    if conn.shape[1] == 4:
        return np.concatenate([conn[:, [0, 1, 2]], conn[:, [0, 2, 3]]])
    raise ValueError(f"conn must be (ne,3) or (ne,4), got {conn.shape}")


def read_plot3d_surf(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """Formatted PLOT3D surface file -> (pts, quad conn). Accepts the
    reference's integration-surface format (pyADflow.py:780: multiblock
    formatted, nk==1 planes)."""
    with open(path) as f:
        tok = f.read().split()
    pos = 0

    def nxt():
        nonlocal pos
        v = tok[pos]
        pos += 1
        return v

    nb = int(nxt())
    dims = []
    for _ in range(nb):
        ni, nj = int(nxt()), int(nxt())
        nk = 1
        # optional third dim (must be 1 for a surface)
        if pos < len(tok) and tok[pos].isdigit():
            save = pos
            v = int(nxt())
            if v == 1:
                nk = 1
            else:
                pos = save
        dims.append((ni, nj))
    pts_all: List[np.ndarray] = []
    conn_all: List[np.ndarray] = []
    off = 0
    for ni, nj in dims:
        n = ni * nj
        coords = np.array([float(nxt()) for _ in range(3 * n)])
        x = coords.reshape(3, nj, ni).transpose(2, 1, 0)   # (ni, nj, 3)
        pts_all.append(x.reshape(-1, 3))
        ii, jj = np.meshgrid(np.arange(ni - 1), np.arange(nj - 1),
                             indexing="ij")
        base = off + (ii * nj + jj).reshape(-1)
        conn_all.append(np.stack(
            [base, base + nj, base + nj + 1, base + 1], axis=1))
        off += n
    return np.concatenate(pts_all), np.concatenate(conn_all)


def _locate_points(mesh: MultiBlockMesh, x_list, p: np.ndarray):
    """Containing-cell association for arbitrary points in the PADDED
    (2-ghost-ring) cell-center grid — surface elements in the half-cell
    rim between the boundary and the first interior center interpolate
    from BC-filled ghost cells, exactly like overset fringe receivers.
    Returns (block, anchor in padded frame, trilinear uvw); block = -1
    for points outside every block (orphans, dropped with a count)."""
    from scipy.spatial import cKDTree
    from adflow_torch.overset.assembly import (
        H, _padded_centers, _trilinear_invert)

    n = len(p)
    best_blk = np.full(n, -1, np.int64)
    best_anchor = np.zeros((n, 3), np.int64)
    best_uvw = np.full((n, 3), 0.5)
    best_miss = np.full(n, np.inf)
    for bi, b in enumerate(mesh.blocks):
        x = np.asarray(x_list[bi], float)
        pc = _padded_centers(x)                  # (ni+2H, nj+2H, nk+2H, 3)
        dims = tuple(d - 1 for d in x.shape[:3])
        if min(dims) < 2:
            continue
        pdims = pc.shape[:3]
        # candidate search on INTERIOR centers only (padded ghost geometry
        # is extrapolated — fine for interpolation, bad for KDTree hits)
        ci = pc[H:-H, H:-H, H:-H]
        tree = cKDTree(ci.reshape(-1, 3))
        _, nearest = tree.query(p)
        n3 = np.stack(np.unravel_index(nearest, dims), axis=1) + H
        for di in (-1, 0):
            for dj in (-1, 0):
                for dk in (-1, 0):
                    a = np.clip(n3 + np.array([di, dj, dk]), 0,
                                np.array(pdims) - 2)
                    corners = np.empty((n, 2, 2, 2, 3))
                    for oi in (0, 1):
                        for oj in (0, 1):
                            for ok in (0, 1):
                                corners[:, oi, oj, ok] = pc[
                                    a[:, 0] + oi, a[:, 1] + oj,
                                    a[:, 2] + ok]
                    u, inb = _trilinear_invert(corners, p)
                    miss = np.maximum(np.maximum(-u, u - 1.0),
                                      0.0).sum(axis=1)
                    better = miss < best_miss - 1e-14
                    take = better & (inb | (best_blk < 0))
                    # containment beats near-miss from another block
                    take |= inb & (best_miss > 1e-10)
                    best_blk[take] = bi
                    best_anchor[take] = a[take]
                    best_uvw[take] = u[take]
                    best_miss[take] = miss[take]
    contained = best_miss < 1e-8
    best_blk[~contained & (best_miss > 0.5)] = -1   # far outside: orphan
    return best_blk, best_anchor, np.clip(best_uvw, 0.0, 1.0)


def build_integration_surface(mesh: MultiBlockMesh, x_list,
                              pts: np.ndarray, conn: np.ndarray,
                              family: str, is_inflow: bool = True
                              ) -> UserIntegrationSurface:
    pts = np.asarray(pts, float).reshape(-1, 3)
    tris = triangulate(pts, conn)
    v0, v1, v2 = pts[tris[:, 0]], pts[tris[:, 1]], pts[tris[:, 2]]
    centers = (v0 + v1 + v2) / 3.0
    svec = 0.5 * np.cross(v1 - v0, v2 - v0)

    blk, anchor, uvw = _locate_points(mesh, x_list, centers)
    keep = blk >= 0
    n_orphans = int((~keep).sum())
    blk, anchor, uvw = blk[keep], anchor[keep], uvw[keep]
    tris, svec = tris[keep], svec[keep]

    # flat indices into the HALO-PADDED state (ni+4, nj+4, nk+4);
    # anchors are already in the padded frame
    pdims = [tuple(d + 4 for d in b.dims) for b in mesh.blocks]
    gf = np.zeros((8, len(blk)), np.int64)
    wt = np.zeros((8, len(blk)))
    u, v, w = uvw[:, 0], uvw[:, 1], uvw[:, 2]
    k = 0
    for oi in (0, 1):
        for oj in (0, 1):
            for ok in (0, 1):
                wu = u if oi else (1.0 - u)
                wv = v if oj else (1.0 - v)
                ww = w if ok else (1.0 - w)
                wt[k] = wu * wv * ww
                for bi in set(int(b) for b in blk):
                    m = blk == bi
                    ni, nj, nk = pdims[bi]
                    gf[k, m] = ((anchor[m, 0] + oi) * nj * nk
                                + (anchor[m, 1] + oj) * nk
                                + (anchor[m, 2] + ok))
                k += 1
    return UserIntegrationSurface(
        family=family, is_inflow=bool(is_inflow), pts=pts, conn=tris,
        blk=blk, gather_flat=gf, weights=wt, svec=svec,
        n_orphans=n_orphans)


def integrate_user_surface(w_list, surf: UserIntegrationSurface,
                           ref: ReferenceState) -> Dict[str, torch.Tensor]:
    """Mass flow + averaged totals on the user surface (the
    flowIntegrationFace quantity set, surfaceIntegrations.F90:894, on
    interpolated states). ``w_list`` is halo-padded; the gathers read the
    padded field, so elements in the boundary half-cell rim interpolate
    from BC-filled ghosts."""
    g = GAMMA
    ne = len(surf.blk)
    like = w_list[0]
    kw = dict(dtype=like.dtype, device=like.device)
    fam = surf.family.lower()
    if ne == 0:
        return {f"{fam}_{k}": torch.zeros((), **kw) for k in
                ("mdot", "mavgptot", "mavgttot", "mavgps", "mavgmn",
                 "area")}
    nv = like.shape[-1]
    wf = torch.zeros((ne, nv), **kw)
    for bi in sorted(set(int(b) for b in surf.blk)):
        m = surf.blk == bi
        flat = w_list[bi].reshape(-1, nv)
        acc = torch.zeros((int(m.sum()), nv), **kw)
        for k in range(8):
            idx = torch.as_tensor(surf.gather_flat[k][m], dtype=torch.int64,
                                  device=like.device)
            acc = acc + torch.as_tensor(surf.weights[k][m], **kw)[:, None] \
                * flat[idx]
        wf = wf.index_copy(0, torch.as_tensor(np.flatnonzero(m),
                                              device=like.device), acc)

    sv = torch.as_tensor(surf.svec, **kw)
    da = torch.linalg.norm(sv, dim=-1)
    rho = wf[..., IRHO]
    vel = wf[..., IMX:IMZ + 1] / rho[..., None]
    p = pressure(wf)
    c2 = g * p / rho
    mn = torch.linalg.norm(vel, dim=-1) / torch.sqrt(c2)
    pt = p * (1.0 + 0.5 * (g - 1.0) * mn ** 2) ** (g / (g - 1.0))
    tt = (g * p / rho) * (1.0 + 0.5 * (g - 1.0) * mn ** 2)
    # mdot positive along the surface normal; isInflow flips so flow INTO
    # an engine face is positive either way the user oriented the plane
    # (reference isInflow flag, pyADflow.py:780)
    sign = 1.0 if surf.is_inflow else -1.0
    dm = sign * rho * torch.sum(vel * sv, dim=-1)
    mdot = torch.sum(dm)
    safe_m = torch.where(torch.abs(mdot) > 1e-30, mdot,
                         torch.ones((), **kw))
    return {
        f"{fam}_mdot": mdot,
        f"{fam}_mavgptot": torch.sum(dm * pt) / safe_m,
        f"{fam}_mavgttot": torch.sum(dm * tt) / safe_m,
        f"{fam}_mavgps": torch.sum(dm * p) / safe_m,
        f"{fam}_mavgmn": torch.sum(dm * mn) / safe_m,
        f"{fam}_area": torch.sum(da),
    }
