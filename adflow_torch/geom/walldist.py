"""Wall-distance computation for turbulence models (counterpart of
adflow_tpu/geom/walldist.py).

Two-stage batched search that stays dense and matmul-shaped:

1. candidate selection — squared distances from every cell center to every
   wall-face center via |a-b|^2 = |a|^2 - 2 a.b + |b|^2 (one matmul,
   ``torch.matmul``), then ``torch.topk`` for the K nearest faces;
2. exact projection — clamped Newton iteration projecting the cell center
   onto each candidate bilinear quad, distances by direct subtraction, so
   near-wall distances stay exact in f32.

TF32 must stay off (adflow_torch/__init__.py): it would perturb the stage-1
ranking. After a mesh deformation ``update_wall_distances`` re-projects each
cell centre onto the wall quad the last full search chose for it.
"""

from __future__ import annotations

import torch

from adflow_torch.core.mesh import VISCOUS_WALL_BCS, WALL_BCS, MultiBlockMesh
from adflow_torch.geom.metrics import cell_centers, pad_like_numpy
from adflow_torch.physics.surface import build_wall_patches

FAR_DIST = 1e10   # "large constant" for beyond-cutoff cells
                  # (reference wallDistCutoff, doc/options.yaml:333)


def gather_wall_quads(mesh: MultiBlockMesh, x_list) -> torch.Tensor:
    """All wall-face corner quads, shape (M, 4, 3) ordered (a, b, c, d) with
    u along a->b and v along a->d. Viscous walls if any exist, else all
    walls."""
    patches = build_wall_patches(mesh, include=VISCOUS_WALL_BCS)
    if not patches:
        patches = build_wall_patches(mesh, include=WALL_BCS)
    quads = []
    for patch in patches:
        xs = x_list[patch.block][patch.fnode_sl]

        def corner(d1, d2, xs=xs):
            return xs[d1:xs.shape[0] - 1 + d1, d2:xs.shape[1] - 1 + d2]

        q = torch.stack([corner(0, 0), corner(1, 0), corner(1, 1),
                         corner(0, 1)], dim=2)
        quads.append(q.reshape(-1, 4, 3))
    if not quads:
        x0 = x_list[0]
        return torch.zeros((0, 4, 3), dtype=x0.dtype, device=x0.device)
    return torch.cat(quads)


def _project_points_quads(p, quads, n_newton: int = 10):
    """Exact closest-point distance from points to bilinear quads.

    p: (..., 3) points; quads: (..., 4, 3) matching batch. Minimizes
    |a + u e0 + v e1 + uv e2 - p|^2 over (u, v) in [0,1]^2: exact edge
    minima, clamped Newton from 5 starts for interior minima, pointwise min
    over all 9 candidates.
    """
    a = quads[..., 0, :]
    e0 = quads[..., 1, :] - a                      # u edge
    e1 = quads[..., 3, :] - a                      # v edge
    e2 = a - quads[..., 1, :] + quads[..., 2, :] - quads[..., 3, :]
    rel = a - p
    scale2 = (torch.sum(e0 * e0, dim=-1) + torch.sum(e1 * e1, dim=-1)
              + 1e-30)
    bshape = torch.broadcast_shapes(p.shape[:-1], quads.shape[:-2])

    def dist2(u, v):
        r = (rel + u[..., None] * e0 + v[..., None] * e1
             + (u * v)[..., None] * e2)
        return torch.sum(r * r, dim=-1)

    def seg_min(base, d):
        """argmin_t |base + t d|, clipped to [0,1] (exact for linear r)."""
        t = -torch.sum(base * d, dim=-1) / (torch.sum(d * d, dim=-1) + 1e-30)
        return torch.clamp(torch.broadcast_to(t, bshape), 0.0, 1.0)

    kw = dict(dtype=p.dtype, device=p.device)
    zero = torch.zeros(bshape, **kw)
    one = torch.ones(bshape, **kw)
    u_v0 = seg_min(rel, e0)                        # edge v=0
    u_v1 = seg_min(rel + e1, e0 + e2)              # edge v=1
    v_u0 = seg_min(rel, e1)                        # edge u=0
    v_u1 = seg_min(rel + e0, e1 + e2)              # edge u=1
    edge_uv = [(u_v0, zero), (u_v1, one), (zero, v_u0), (one, v_u1)]

    starts = [(torch.full(bshape, 0.5, **kw), torch.full(bshape, 0.5, **kw))]
    for (su, sv) in edge_uv:
        starts.append((0.75 * su + 0.125, 0.75 * sv + 0.125))
    u = torch.stack([s[0] for s in starts])
    v = torch.stack([s[1] for s in starts])
    for _ in range(n_newton):
        xu = e0 + v[..., None] * e2
        xv = e1 + u[..., None] * e2
        r = (rel + u[..., None] * e0 + v[..., None] * e1
             + (u * v)[..., None] * e2)
        g0 = torch.sum(r * xu, dim=-1)
        g1 = torch.sum(r * xv, dim=-1)
        re2 = torch.sum(r * e2, dim=-1)
        # regularize: keeps the step defined on collapsed quad edges
        eps = 1e-12 * scale2
        h00 = torch.sum(xu * xu, dim=-1) + eps
        h11 = torch.sum(xv * xv, dim=-1) + eps
        h01 = torch.sum(xu * xv, dim=-1) + re2
        det = h00 * h11 - h01 * h01
        tiny = 1e-30 * scale2 * scale2
        det = torch.where(torch.abs(det) < tiny, tiny, det)
        du = (h11 * g0 - h01 * g1) / det
        dv = (h00 * g1 - h01 * g0) / det
        u = torch.clamp(u - du, 0.0, 1.0)
        v = torch.clamp(v - dv, 0.0, 1.0)

    best = torch.amin(dist2(u, v), dim=0)
    for (su, sv) in edge_uv:
        best = torch.minimum(best, dist2(su, sv))
    return torch.sqrt(best)


def _nearest_quad_dist_assoc(xc, quads, centers, k: int = 8):
    """Exact projected distance to the nearest wall quad per point, with the
    winning quad index; candidates by top-k on the matmul-form center
    distances."""
    k = min(k, centers.shape[0])
    a2 = torch.sum(xc * xc, dim=-1, keepdim=True)
    b2 = torch.sum(centers * centers, dim=-1)[None, :]
    d2 = a2 - 2.0 * (xc @ centers.T) + b2          # sloppy: ranking only
    _, idx = torch.topk(-d2, k, dim=-1)            # (n, k)
    d = _project_points_quads(xc[:, None, :], quads[idx])
    j = torch.argmin(d, dim=-1)
    rows = torch.arange(idx.shape[0], device=idx.device)
    return d[rows, j], idx[rows, j]


def _apply_cutoff(d, cutoff):
    if cutoff is None or cutoff >= FAR_DIST:
        return d
    return torch.where(d > cutoff, torch.full_like(d, FAR_DIST), d)


def compute_wall_distances(mesh: MultiBlockMesh, x_list,
                           chunk: int = 1 << 15, cutoff: float = None,
                           return_assoc: bool = False):
    """Per-block wall distance on the one-ring extended cell grid
    (ni+2, nj+2, nk+2), edge padded. ``x_list`` holds the node tensors in
    the working dtype and device. ``return_assoc=True`` also returns each
    block's flat winning quad index (int64 tensors on the device, None
    without walls): the point -> wall element association that
    ``update_wall_distances`` re-evaluates after a mesh deformation."""
    quads = gather_wall_quads(mesh, x_list)
    centers = torch.mean(quads, dim=1)
    out = []
    assoc = []
    for x in x_list:
        xc = cell_centers(x)
        shp = xc.shape[:3]
        flat = xc.reshape(-1, 3)
        if quads.shape[0] == 0:
            d = torch.full((flat.shape[0],), FAR_DIST, dtype=x.dtype,
                           device=x.device)
            assoc.append(None)
        else:
            parts = [_nearest_quad_dist_assoc(flat[s:s + chunk], quads,
                                              centers)
                     for s in range(0, flat.shape[0], chunk)]
            d = torch.cat([p[0] for p in parts])
            assoc.append(torch.cat([p[1] for p in parts]))
        d = pad_like_numpy(d.reshape(shp), 1, "edge")
        out.append(_apply_cutoff(torch.clamp(d, min=1e-14), cutoff))
    if return_assoc:
        return out, assoc
    return out


def update_wall_distances(mesh: MultiBlockMesh, x_list, assoc,
                          cutoff: float = None):
    """The quick wall-distance update after a mesh deformation (reference
    updateWallDistancesQuickly, wallDistance.F90:36, option
    useApproxWallDistance): each cell centre is projected onto its stored
    nearest wall quad (``assoc`` from the last full search) at the quad's
    new coordinates, exact where the nearest element did not change, O(n)
    instead of O(n M)."""
    quads = gather_wall_quads(mesh, x_list)
    out = []
    for x, a in zip(x_list, assoc):
        xc = cell_centers(x)
        shp = xc.shape[:3]
        flat = xc.reshape(-1, 3)
        if a is None or quads.shape[0] == 0:
            d = torch.full((flat.shape[0],), FAR_DIST, dtype=x.dtype,
                           device=x.device)
        else:
            d = _project_points_quads(flat, quads[torch.as_tensor(
                a, dtype=torch.int64, device=x.device)])
        d = pad_like_numpy(d.reshape(shp), 1, "edge")
        out.append(_apply_cutoff(torch.clamp(d, min=1e-14), cutoff))
    return out
