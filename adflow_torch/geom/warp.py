"""Inverse-distance-weighted volume mesh warping (counterpart of
adflow_tpu/geom/warp.py).

Reference analogue: ADflow delegates volume warping to IDWarp via
``setMesh``/``ADFLOW.setSurfaceCoordinates`` (pyADflow.py:380,3208; the
MPhys ADflowWarper component, mphys_adflow.py:352). Surface displacements
are diffused into the volume with Shepard (inverse-distance) weights, with
zero-displacement anchors on the non-wall boundaries so the far field stays
put.

The weights of a chunk of query nodes against every control point are one
(chunk, n_ctl) array: the squared distance is summed coordinate by
coordinate, so no (chunk, n_ctl, 3) temporary is made, and the chunk is
sized so a few such arrays fit in a few GB at full width. Differentiable in
the surface displacements.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from adflow_torch.core.mesh import WALL_BCS, MultiBlockMesh

# query nodes per chunk: with about 2e4 control points (a 257x65 wall plus
# 2000 anchors) a (chunk, n_ctl) f32 array is 0.3 GB
CHUNK = 4096


def _boundary_anchor_nodes(mesh: MultiBlockMesh) -> np.ndarray:
    """Nodes of all non-wall physical boundaries (farfield etc.): anchors
    that must not move, thinned to about 2000."""
    pts = []
    for blk in mesh.blocks:
        for sf in blk.bcs:
            if sf.bc in WALL_BCS:
                continue
            ax = sf.face.axis
            idx = [slice(None)] * 3
            idx[ax] = -1 if sf.face.is_high else 0
            pts.append(blk.x[tuple(idx)].reshape(-1, 3))
    if not pts:
        return np.zeros((0, 3))
    allp = np.concatenate(pts)
    # thin out: warping accuracy at anchors only needs coverage
    if len(allp) > 2000:
        allp = allp[:: len(allp) // 2000 + 1]
    return allp


def _idw_disp(xq, ctl_pts, ctl_disp, power: float = 3.0, eps: float = 1e-10):
    """Shepard interpolation of control displacements at query points.

    xq: (nq, 3); ctl_pts: (nc, 3); ctl_disp: (nc, 3) -> (nq, 3).
    """
    d2 = (xq[:, None, 0] - ctl_pts[None, :, 0]) ** 2
    d2 = d2 + (xq[:, None, 1] - ctl_pts[None, :, 1]) ** 2
    d2 = d2 + (xq[:, None, 2] - ctl_pts[None, :, 2]) ** 2
    w = 1.0 / (d2 ** (power / 2.0) + eps)
    return (w @ ctl_disp) / torch.sum(w, dim=1, keepdim=True)


def warp_mesh(mesh: MultiBlockMesh, x_list: List[torch.Tensor],
              surf_pts0, surf_disp, anchors: Optional[np.ndarray] = None,
              chunk: int = CHUNK) -> List[torch.Tensor]:
    """Warp every block's nodes given wall-surface displacements.

    surf_pts0: (ns, 3) original surface node positions (numpy); surf_disp:
    (ns, 3) their displacements (numpy or a tensor). The anchors default to
    ``mesh``'s non-wall boundary nodes. Returns the new x_list (same
    shapes, dtype and device; differentiable in a tensor ``surf_disp``).
    """
    if anchors is None:
        anchors = _boundary_anchor_nodes(mesh)
    surf_pts0 = np.asarray(surf_pts0, float)
    if len(anchors):
        # drop anchors that coincide with / crowd the moving surface
        # (symmetry planes share their wall-ring nodes with the wall)
        from scipy.spatial import cKDTree
        d, _ = cKDTree(surf_pts0).query(anchors)
        span = float(np.ptp(surf_pts0, axis=0).max())
        anchors = anchors[d > 0.05 * max(span, 1e-12)]
    x0 = x_list[0]
    kw = dict(dtype=x0.dtype, device=x0.device)
    ctl_pts = torch.as_tensor(np.concatenate([surf_pts0, anchors]), **kw)
    ctl_disp = torch.cat([torch.as_tensor(surf_disp, **kw),
                          torch.zeros((len(anchors), 3), **kw)])
    out = []
    for x in x_list:
        flat = x.reshape(-1, 3)
        disp = torch.cat([_idw_disp(flat[s:s + chunk], ctl_pts, ctl_disp)
                          for s in range(0, flat.shape[0], chunk)])
        out.append((flat + disp).reshape(x.shape))
    return out
