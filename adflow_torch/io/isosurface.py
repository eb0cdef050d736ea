"""Isosurface extraction (marching tetrahedra) for volume output.

Reference analogue: the isosurface machinery of the CGNS/Tecplot volume
writer (`ADflow: src/output/outputMod.F90:68` isosurface variable
setup + the writer plumbing): the user supplies the ``isoSurface`` option
as ``{variable: value}`` and the writer emits triangulated surfaces.

Host-side NumPy (IO path, off the hot loop): each hex cell splits into 6
tetrahedra; each tet crossing the isovalue emits 1 or 2 triangles with
vertices linearly interpolated along its edges. Marching TETS instead of
marching cubes: no 256-case table, no ambiguous faces, fully vectorizable
with boolean masks over the 16 sign configurations.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

# 6-tet decomposition of the unit hex (vertex ids 0..7 = binary (di,dj,dk))
_HEX_TETS = np.array([
    [0, 1, 3, 7], [0, 1, 7, 5], [0, 5, 7, 4],
    [0, 3, 2, 7], [0, 2, 6, 7], [0, 6, 4, 7],
])
_TET_EDGES = [(0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3)]


def _node_field(c: np.ndarray) -> np.ndarray:
    """Cell field (ni,nj,nk) -> node field (ni+1,nj+1,nk+1) by averaging."""
    ni, nj, nk = c.shape
    node = np.zeros((ni + 1, nj + 1, nk + 1))
    w = np.zeros_like(node)
    for di in (0, 1):
        for dj in (0, 1):
            for dk in (0, 1):
                node[di:ni + di, dj:nj + dj, dk:nk + dk] += c
                w[di:ni + di, dj:nj + dj, dk:nk + dk] += 1.0
    return node / np.maximum(w, 1.0)


def marching_tets(x: np.ndarray, v_node: np.ndarray, iso: float
                  ) -> np.ndarray:
    """Triangles (n_tri, 3, 3) of the iso-level set of the node field.

    x: (ni+1, nj+1, nk+1, 3) nodes; v_node: matching scalar node field.
    """
    ni, nj, nk = (s - 1 for s in v_node.shape)
    # hex corner node indices for every cell, order = binary (di,dj,dk)
    I, J, K = np.meshgrid(np.arange(ni), np.arange(nj), np.arange(nk),
                          indexing="ij")
    corners = []
    for di in (0, 1):
        for dj in (0, 1):
            for dk in (0, 1):
                corners.append((I + di, J + dj, K + dk))
    vx = np.stack([x[c] for c in corners], axis=-2)      # (.., 8, 3)
    vv = np.stack([v_node[c] for c in corners], axis=-1)  # (.., 8)
    vx = vx.reshape(-1, 8, 3)
    vv = vv.reshape(-1, 8)

    tris: List[np.ndarray] = []
    for tet in _HEX_TETS:
        tx = vx[:, tet]                  # (n, 4, 3)
        tv = vv[:, tet]                  # (n, 4)
        inside = tv > iso                # (n, 4)
        code = (inside * (1 << np.arange(4))).sum(axis=1)

        def edge_point(sel, a, b):
            va, vb = tv[sel, a], tv[sel, b]
            t = (iso - va) / np.where(np.abs(vb - va) < 1e-300, 1e-300,
                                      vb - va)
            t = np.clip(t, 0.0, 1.0)[:, None]
            return tx[sel, a] * (1 - t) + tx[sel, b] * t

        for c in range(1, 15):
            sel = np.nonzero(code == c)[0]
            if len(sel) == 0:
                continue
            ins = [i for i in range(4) if (c >> i) & 1]
            out = [i for i in range(4) if not (c >> i) & 1]
            if len(ins) == 1 or len(ins) == 3:
                a = ins[0] if len(ins) == 1 else out[0]
                rest = out if len(ins) == 1 else ins
                p = [edge_point(sel, a, b) for b in rest]
                tris.append(np.stack(p, axis=1))
            else:                        # 2-2: quad -> 2 triangles
                a, b = ins
                cc, d = out
                pac = edge_point(sel, a, cc)
                pad = edge_point(sel, a, d)
                pbc = edge_point(sel, b, cc)
                pbd = edge_point(sel, b, d)
                tris.append(np.stack([pac, pad, pbd], axis=1))
                tris.append(np.stack([pac, pbd, pbc], axis=1))
    if not tris:
        return np.zeros((0, 3, 3))
    return np.concatenate(tris, axis=0)


def write_isosurface_tecplot(fileName: str, surfaces) -> None:
    """surfaces: list of (zone_name, triangles (n,3,3))."""
    with open(fileName, "w") as f:
        f.write('TITLE = "adflow_torch isosurfaces"\n')
        f.write('VARIABLES = "CoordinateX" "CoordinateY" "CoordinateZ"\n')
        for name, tri in surfaces:
            n = len(tri)
            if n == 0:
                continue
            f.write(f'ZONE T="{name}" N={3 * n} E={n} '
                    "ZONETYPE=FETRIANGLE DATAPACKING=POINT\n")
            pts = tri.reshape(-1, 3)
            np.savetxt(f, pts, fmt="%15.8g")
            conn = np.arange(1, 3 * n + 1).reshape(-1, 3)
            np.savetxt(f, conn, fmt="%d")
