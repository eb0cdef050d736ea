"""Analytic structured-mesh generators for tests and benchmarks.

The reference downloads its test meshes (tutorial wing, CRM...) from an
mdolab tarball (`ADflow: input_files/get-input-files.sh`). This
framework ships self-contained generators for the same *kinds* of cases the
reference regression suite covers (tests/reg_tests): NACA0012 Euler, laminar
flat plate, RANS airfoil, 3D wing, plus free-stream-preservation meshes.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np

from adflow_torch.core.mesh import (
    B2BConnection, BCSubface, BCType, Block, Face, MultiBlockMesh)


# ---------------------------------------------------------------------------
# Basic boxes
# ---------------------------------------------------------------------------

def cube_mesh(n: int = 8, lo=(0.0, 0.0, 0.0), hi=(1.0, 1.0, 1.0),
              bc: BCType = BCType.FARFIELD, perturb: float = 0.0,
              seed: int = 0) -> MultiBlockMesh:
    """Uniform (optionally randomly perturbed) box with one BC type on all
    faces. Perturbed interior nodes make free-stream preservation a real test
    of metric consistency."""
    xs = [np.linspace(lo[d], hi[d], n + 1) for d in range(3)]
    x = np.stack(np.meshgrid(*xs, indexing="ij"), axis=-1)
    if perturb > 0:
        rng = np.random.default_rng(seed)
        h = min((hi[d] - lo[d]) / n for d in range(3))
        noise = rng.uniform(-perturb * h, perturb * h, size=x.shape)
        # keep boundary nodes fixed
        mask = np.zeros(x.shape[:3] + (1,))
        mask[1:-1, 1:-1, 1:-1] = 1.0
        x = x + noise * mask
    bcs = [BCSubface(face=f, bc=bc, family="far") for f in Face]
    blk = Block(name="cube", x=x, bcs=bcs)
    return MultiBlockMesh(blocks=[blk], name="cube")


def channel_mesh(ni=32, nj=16, nk=2, length=3.0, height=1.0, width=0.2,
                 bump: float = 0.0) -> MultiBlockMesh:
    """Subsonic channel (internal flow): subsonic inflow at imin, subsonic
    outflow at imax, slip walls jmin/jmax, symmetry in k. Optional sinusoidal
    bump on the lower wall (the classic 10%-bump verification case; reference
    analogue: tests/reg_tests/test_2D_conv_nozzle.py class of cases)."""
    xi = np.linspace(0.0, length, ni + 1)
    eta = np.linspace(0.0, 1.0, nj + 1)
    zeta = np.linspace(0.0, width, nk + 1)
    X, E, Z = np.meshgrid(xi, eta, zeta, indexing="ij")
    if bump > 0:
        yb = np.where(
            (X > length / 3) & (X < 2 * length / 3),
            bump * np.sin(np.pi * (X - length / 3) / (length / 3)) ** 2,
            0.0)
    else:
        yb = np.zeros_like(X)
    Y = yb + E * (height - yb)
    x = np.stack([X, Y, Z], axis=-1)
    bcs = [
        BCSubface(Face.IMIN, BCType.SUBSONIC_INFLOW, family="inflow",
                  data={"Pt": None, "Tt": None}),
        BCSubface(Face.IMAX, BCType.SUBSONIC_OUTFLOW, family="outflow",
                  data={"P": None}),
        BCSubface(Face.JMIN, BCType.EULER_WALL, family="lower_wall"),
        BCSubface(Face.JMAX, BCType.EULER_WALL, family="upper_wall"),
        BCSubface(Face.KMIN, BCType.SYMMETRY, family="sym"),
        BCSubface(Face.KMAX, BCType.SYMMETRY, family="sym"),
    ]
    return MultiBlockMesh([Block("channel", x, bcs)], name="channel")


# ---------------------------------------------------------------------------
# NACA 4-digit airfoil O-mesh (2D: one cell + symmetry in k)
# ---------------------------------------------------------------------------

def naca4_coords(s: np.ndarray, thickness: float = 0.12) -> np.ndarray:
    """Closed-TE NACA 00xx surface. s in [0,1] wraps from the trailing edge
    along the lower surface, around the LE, back to the TE (clockwise seen
    from +z, which makes the O-mesh block right-handed: i along the surface,
    j outward from the body, k = +z)."""
    theta = 2.0 * math.pi * s
    xc = 0.5 * (1.0 + np.cos(theta))        # 1 -> 0 -> 1
    t5 = 5.0 * thickness
    yt = t5 * (0.2969 * np.sqrt(np.maximum(xc, 0.0)) - 0.1260 * xc
               - 0.3516 * xc ** 2 + 0.2843 * xc ** 3 - 0.1036 * xc ** 4)
    y = np.where(s < 0.5, -yt, yt)
    return np.stack([xc, y], axis=-1)


def naca0012_omesh(ni: int = 128, nj: int = 48, radius: float = 20.0,
                   width: float = 1.0, thickness: float = 0.12,
                   wall_spacing: Optional[float] = None,
                   viscous: bool = False, nk: int = 1) -> MultiBlockMesh:
    """O-mesh around a NACA00xx airfoil, extruded one layer (nk=1) in z with
    symmetry BCs — the reference's quasi-2D idiom. i wraps around the body
    (periodic self-connection), j goes surface -> farfield circle.

    ``wall_spacing``: first cell height at the wall; default chord/nj/5 for
    Euler, 2e-5 for viscous (y+ ~ O(1) at Re ~ 1e6 scale meshes).
    """
    s = np.linspace(0.0, 1.0, ni + 1)[:-1]     # wrap: last point == first
    surf = naca4_coords(s, thickness)
    center = np.array([0.5, 0.0])

    if wall_spacing is None:
        wall_spacing = 2e-5 if viscous else 1.0 / (nj * 5.0)
    # geometric stretching from wall_spacing to farfield radius
    eta = _stretched_coords(nj, wall_spacing, radius)

    # radial rays from the surface away from the chord center; march off the
    # surface along each ray with the stretched wall-normal distribution
    dirs = surf - center
    dirs = dirs / np.linalg.norm(dirs, axis=-1, keepdims=True)
    xy = surf[:, None, :] + dirs[:, None, :] * eta[None, :, None]

    z = np.linspace(0.0, width, nk + 1)
    x = np.zeros((ni + 1, nj + 1, nk + 1, 3))
    xy_wrap = np.concatenate([xy, xy[:1]], axis=0)   # close the O
    x[:, :, :, 0] = xy_wrap[:, :, 0][:, :, None]
    x[:, :, :, 1] = xy_wrap[:, :, 1][:, :, None]
    x[:, :, :, 2] = z[None, None, :]

    wall = (BCType.NS_WALL_ADIABATIC if viscous else BCType.EULER_WALL)
    bcs = [
        BCSubface(Face.JMIN, wall, family="wall"),
        BCSubface(Face.JMAX, BCType.FARFIELD, family="far"),
        BCSubface(Face.KMIN, BCType.SYMMETRY, family="sym"),
        BCSubface(Face.KMAX, BCType.SYMMETRY, family="sym"),
    ]
    conns = [
        # O-topology wrap: imin's halo donors are the last interior cells.
        B2BConnection(Face.IMIN, donor_block=0, donor_face=Face.IMAX,
                      transform=(1, 2, 3), offset=(ni, 0, 0)),
        B2BConnection(Face.IMAX, donor_block=0, donor_face=Face.IMIN,
                      transform=(1, 2, 3), offset=(-ni, 0, 0)),
    ]
    blk = Block("naca0012", x, bcs, conns)
    return MultiBlockMesh([blk], name="naca0012_omesh")


def _stretched_coords(n: int, d0: float, total: float) -> np.ndarray:
    """n+1 coordinates in [0, total] with first spacing d0, geometric ratio
    solved by bisection. Returns uniform spacing if d0 >= total/n."""
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


# ---------------------------------------------------------------------------
# Laminar flat plate
# ---------------------------------------------------------------------------

def flatplate_mesh(ni=48, nj=32, plate_start_frac=0.25, length=1.0,
                   height=0.5, width=0.05, wall_spacing=5e-4,
                   isothermal: Optional[float] = None,
                   nk: int = 1) -> MultiBlockMesh:
    """Laminar flat-plate: symmetry upstream of the plate then no-slip wall
    on jmin; inflow/outflow on imin/imax; farfield above. Reference analogue:
    the laminar-NS regression cases (tests/reg_tests/test_solve.py laminar)."""
    n_up = max(2, int(round(ni * plate_start_frac)))
    x_up = np.linspace(-plate_start_frac * length / (1 - plate_start_frac) , 0.0, n_up + 1)
    x_plate = _stretched_coords(ni - n_up, length / (ni - n_up) / 3.0, length)
    xi = np.concatenate([x_up, x_plate[1:]])
    eta = _stretched_coords(nj, wall_spacing, height)
    zeta = np.linspace(0.0, width, nk + 1)
    X, Y, Z = np.meshgrid(xi, eta, zeta, indexing="ij")
    x = np.stack([X, Y, Z], axis=-1)

    wall_bc = (BCType.NS_WALL_ISOTHERMAL if isothermal is not None
               else BCType.NS_WALL_ADIABATIC)
    bcs = [
        BCSubface(Face.IMIN, BCType.FARFIELD, family="inflow"),
        # pressure-anchored outflow: plain extrapolation drifts/reflects at
        # subsonic outflow and destabilizes the boundary layer downstream
        BCSubface(Face.IMAX, BCType.SUBSONIC_OUTFLOW, family="outflow",
                  data={"P": None}),
        BCSubface(Face.JMIN, BCType.SYMMETRY, family="sym_up",
                  rng=((0, n_up), (0, nk))),
        BCSubface(Face.JMIN, wall_bc, family="wall",
                  rng=((n_up, ni), (0, nk)),
                  data=({"T": isothermal} if isothermal is not None else None)),
        BCSubface(Face.JMAX, BCType.FARFIELD, family="far"),
        BCSubface(Face.KMIN, BCType.SYMMETRY, family="sym"),
        BCSubface(Face.KMAX, BCType.SYMMETRY, family="sym"),
    ]
    return MultiBlockMesh([Block("plate", x, bcs)], name="flatplate")


# ---------------------------------------------------------------------------
# Simple 3D wing (extruded airfoil O-mesh, symmetry root, farfield tip cap
# approximated by extrapolation) — the tutorial-wing analogue.
# ---------------------------------------------------------------------------

def wing_omesh(ni=64, nj=24, nk=16, span=3.0, radius=15.0,
               thickness=0.12, taper=0.6, viscous=False,
               wall_spacing: Optional[float] = None) -> MultiBlockMesh:
    """Extruded tapered wing O-mesh: i around the airfoil (wrap), j to the
    farfield, k spanwise root->tip. Root symmetry plane, farfield beyond the
    tip (reference analogue: the tutorial wing of tests/reg_tests)."""
    m2d = naca0012_omesh(ni, nj, radius=radius, thickness=thickness,
                         viscous=viscous, wall_spacing=wall_spacing)
    sec = m2d.blocks[0].x[:, :, 0, :2]  # (ni+1, nj+1, 2)
    z = np.linspace(0.0, span, nk + 1)
    frac = z / span
    chord = 1.0 + (taper - 1.0) * frac
    x = np.zeros((ni + 1, nj + 1, nk + 1, 3))
    for k in range(nk + 1):
        c = chord[k]
        x[:, :, k, 0] = sec[:, :, 0] * c + 0.25 * (1.0 - c)
        x[:, :, k, 1] = sec[:, :, 1] * c
        x[:, :, k, 2] = z[k]
    wall = (BCType.NS_WALL_ADIABATIC if viscous else BCType.EULER_WALL)
    bcs = [
        BCSubface(Face.JMIN, wall, family="wall"),
        BCSubface(Face.JMAX, BCType.FARFIELD, family="far"),
        BCSubface(Face.KMIN, BCType.SYMMETRY, family="sym"),
        BCSubface(Face.KMAX, BCType.FARFIELD, family="far"),
    ]
    conns = [
        B2BConnection(Face.IMIN, 0, Face.IMAX, (1, 2, 3), (ni, 0, 0)),
        B2BConnection(Face.IMAX, 0, Face.IMIN, (1, 2, 3), (-ni, 0, 0)),
    ]
    return MultiBlockMesh([Block("wing", x, bcs, conns)], name="wing_omesh")
