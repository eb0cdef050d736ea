"""Geometric slices of the wall surface (plane cuts with surface data).

Reference analogue: ``addSlices`` / arbitrary+cylindrical slices and the
Tecplot slice writer (`ADflow: adflow/pyADflow.py:516,580,655`,
`src/output/tecplotIO.F90:9-23`). Host-side NumPy post-processing, off the
hot path (SURVEY.md §7(g)).
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

_EDGES = ((0, 1), (1, 2), (2, 3), (3, 0))  # quad corner cycle


def slice_quads(corners: np.ndarray, vals: Dict[str, np.ndarray],
                p0: np.ndarray, normal: np.ndarray):
    """Intersect a structured quad patch with a plane.

    corners: (m+1, n+1, 3) patch nodes; vals: per-face arrays (m, n);
    returns (segments (ns, 2, 3), {name: (ns,)}).
    """
    d = (corners - p0) @ normal
    # per-face corner cycle c00 -> c10 -> c11 -> c01
    cs = np.stack([corners[:-1, :-1], corners[1:, :-1],
                   corners[1:, 1:], corners[:-1, 1:]], axis=2)  # (m,n,4,3)
    ds = np.stack([d[:-1, :-1], d[1:, :-1], d[1:, 1:], d[:-1, 1:]],
                  axis=2)                                       # (m,n,4)
    segs: List[np.ndarray] = []
    out_vals: Dict[str, List[float]] = {k: [] for k in vals}
    m, n = ds.shape[:2]
    crossed = np.zeros((m, n), bool)
    pts_per_face = [[[] for _ in range(n)] for _ in range(m)]
    for (a, b) in _EDGES:
        da, db = ds[..., a], ds[..., b]
        hit = (da * db) < 0.0
        t = np.where(hit, da / np.where(da - db == 0, 1.0, da - db), 0.0)
        p = cs[..., a, :] + t[..., None] * (cs[..., b, :] - cs[..., a, :])
        ii, jj = np.nonzero(hit)
        for i, j in zip(ii, jj):
            pts_per_face[i][j].append(p[i, j])
            crossed[i, j] = True
    for i in range(m):
        for j in range(n):
            pts = pts_per_face[i][j]
            if len(pts) >= 2:
                segs.append(np.stack([pts[0], pts[1]]))
                for k in vals:
                    out_vals[k].append(float(vals[k][i, j]))
    if not segs:
        return np.zeros((0, 2, 3)), {k: np.zeros(0) for k in vals}
    return np.stack(segs), {k: np.asarray(v) for k, v in out_vals.items()}


def write_tecplot_slices(fileName: str, slices) -> None:
    """slices: list of (name, segments (ns,2,3), {var: (ns,)}) — writes an
    ASCII Tecplot FELINESEG file (one zone per slice)."""
    names: List[str] = []
    for _, _, v in slices:
        for k in v:
            if k not in names:
                names.append(k)
    with open(fileName, "w") as f:
        f.write('TITLE = "adflow_torch slices"\n')
        f.write('VARIABLES = "X" "Y" "Z"'
                + "".join(f' "{n}"' for n in names) + "\n")
        for zname, segs, v in slices:
            ns = len(segs)
            if ns == 0:
                continue
            f.write(f'ZONE T="{zname}", N={2 * ns}, E={ns}, '
                    f'DATAPACKING=POINT, ZONETYPE=FELINESEG\n')
            for s in range(ns):
                for e in range(2):
                    row = list(segs[s, e])
                    row += [float(v[n][s]) if n in v else 0.0
                            for n in names]
                    f.write(" ".join(f"{x:.12e}" for x in row) + "\n")
            for s in range(ns):
                f.write(f"{2 * s + 1} {2 * s + 2}\n")
