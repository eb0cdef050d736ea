"""The benchmark's own copy of the analytic M6-class wing generator
(``wing_omesh`` and what it uses, from adflow_torch's
``meshgen/analytic.py``), so that a change to the program's generator does
not move the yardstick.

``wing_spec`` returns the mesh as plain data: node coordinates and the
boundary conditions and connections by name. ``build_mesh`` turns that
into the mesh classes of a given module: the program's
(``adflow_torch.core.mesh``) for the system under test, the reference's
(``benchmark.reference.mesh``) for the reference, so both are handed the
same coordinates and the same boundary specification.

The coordinates are rounded to float32 once, here: the program computes in
float32 from them, and the reference in float64 from the very same node
positions, so the comparison does not charge the program for rounding its
input.
"""

from __future__ import annotations

import math

import numpy as np


def _naca4_coords(s: np.ndarray, thickness: float) -> np.ndarray:
    """Closed-TE NACA 00xx surface; s in [0, 1) wraps from the trailing edge
    along the lower surface, around the LE, back to the TE."""
    theta = 2.0 * math.pi * s
    xc = 0.5 * (1.0 + np.cos(theta))
    t5 = 5.0 * thickness
    yt = t5 * (0.2969 * np.sqrt(np.maximum(xc, 0.0)) - 0.1260 * xc
               - 0.3516 * xc ** 2 + 0.2843 * xc ** 3 - 0.1036 * xc ** 4)
    y = np.where(s < 0.5, -yt, yt)
    return np.stack([xc, y], axis=-1)


def _stretched_coords(n: int, d0: float, total: float) -> np.ndarray:
    """n+1 coordinates in [0, total] with first spacing d0, geometric ratio
    solved by bisection; uniform if d0 >= total/n."""
    if d0 * n >= total:
        return np.linspace(0.0, total, n + 1)

    def length(r):
        return d0 * (r ** n - 1.0) / (r - 1.0)

    lo_r, hi_r = 1.0 + 1e-12, 10.0
    while length(hi_r) < total:
        hi_r *= 2.0
    for _ in range(200):
        mid = 0.5 * (lo_r + hi_r)
        if length(mid) < total:
            lo_r = mid
        else:
            hi_r = mid
    r = 0.5 * (lo_r + hi_r)
    steps = d0 * r ** np.arange(n)
    coords = np.concatenate([[0.0], np.cumsum(steps)])
    return coords * (total / coords[-1])


def _section(ni, nj, radius, thickness, viscous, wall_spacing):
    """The (ni+1, nj+1, 2) O-mesh of the airfoil section: radial rays from
    the chord centre, stretched from the wall to the farfield circle."""
    s = np.linspace(0.0, 1.0, ni + 1)[:-1]
    surf = _naca4_coords(s, thickness)
    center = np.array([0.5, 0.0])
    if wall_spacing is None:
        wall_spacing = 2e-5 if viscous else 1.0 / (nj * 5.0)
    eta = _stretched_coords(nj, wall_spacing, radius)
    dirs = surf - center
    dirs = dirs / np.linalg.norm(dirs, axis=-1, keepdims=True)
    xy = surf[:, None, :] + dirs[:, None, :] * eta[None, :, None]
    return np.concatenate([xy, xy[:1]], axis=0)


def wing_spec(ni=64, nj=24, nk=16, span=3.0, radius=15.0, thickness=0.12,
              taper=0.6, viscous=False, wall_spacing=None) -> dict:
    """Extruded tapered wing O-mesh: i around the airfoil (a periodic
    self-connection), j to the farfield, k spanwise root to tip; root
    symmetry plane, farfield beyond the tip. Returns plain data."""
    sec = _section(ni, nj, radius, thickness, viscous, wall_spacing)
    z = np.linspace(0.0, span, nk + 1)
    chord = 1.0 + (taper - 1.0) * (z / span)
    x = np.zeros((ni + 1, nj + 1, nk + 1, 3))
    for k in range(nk + 1):
        c = chord[k]
        x[:, :, k, 0] = sec[:, :, 0] * c + 0.25 * (1.0 - c)
        x[:, :, k, 1] = sec[:, :, 1] * c
        x[:, :, k, 2] = z[k]
    x = x.astype(np.float32).astype(np.float64)
    wall = "ns wall adiabatic" if viscous else "euler wall"
    return {"name": "wing_omesh", "blocks": [{
        "name": "wing", "x": x,
        "bcs": [("JMIN", wall, "wall"), ("JMAX", "farfield", "far"),
                ("KMIN", "symmetry", "sym"), ("KMAX", "farfield", "far")],
        "conns": [("IMIN", 0, "IMAX", (1, 2, 3), (ni, 0, 0)),
                  ("IMAX", 0, "IMIN", (1, 2, 3), (-ni, 0, 0))],
    }]}


def build_mesh(spec: dict, mod):
    """The mesh of ``spec`` in the classes of module ``mod`` (BCType, Face,
    BCSubface, B2BConnection, Block, MultiBlockMesh)."""
    blocks = []
    for b in spec["blocks"]:
        bcs = [mod.BCSubface(mod.Face[f], mod.BCType(bc), family=fam)
               for f, bc, fam in b["bcs"]]
        conns = [mod.B2BConnection(mod.Face[f], donor, mod.Face[df],
                                   tuple(t), tuple(o))
                 for f, donor, df, t, o in b["conns"]]
        blocks.append(mod.Block(b["name"], b["x"].copy(), bcs, conns))
    return mod.MultiBlockMesh(blocks, name=spec["name"])
