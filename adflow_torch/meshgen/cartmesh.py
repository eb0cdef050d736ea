"""Cartesian background-mesh generation for overset configurations
(counterpart of adflow_tpu/meshgen/cartmesh.py, numpy).

Reference analogue: `src/overset/cartMesh.F90:13`
(``createCartMesh``, 1,027 LoC): bounding box + average face area of the
wall surfaces determine a target cell size; a Cartesian block with a
uniform core around the body and geometric stretching to the far field is
generated as the overset background grid (the reference writes it to a
CGNS file; here it is returned/appended as a live Block).

The near-body mesh keeps its OVERSET outer boundary; the generated
background carries FARFIELD on all outer faces and is hole-cut around the
body by the implicit hole cutting in overset/assembly.py.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from adflow_torch.core.mesh import (
    BCSubface, BCType, Block, Face, MultiBlockMesh, WALL_BCS)


def _wall_bbox_and_spacing(mesh: MultiBlockMesh):
    """Bounding box and mean face size of all wall surfaces (the
    reference's xMin/xMax + areaAvg sweep, cartMesh.F90:60-110)."""
    lo = np.full(3, np.inf)
    hi = np.full(3, -np.inf)
    areas = []
    for b in mesh.blocks:
        for sf in b.bcs:
            if sf.bc not in WALL_BCS:
                continue
            ax = sf.face.axis
            sl = [slice(None)] * 3
            sl[ax] = -1 if sf.face.is_high else 0
            xs = b.x[tuple(sl)]
            lo = np.minimum(lo, xs.reshape(-1, 3).min(axis=0))
            hi = np.maximum(hi, xs.reshape(-1, 3).max(axis=0))
            v1 = xs[1:, 1:] - xs[:-1, :-1]
            v2 = xs[:-1, 1:] - xs[1:, :-1]
            a = 0.5 * np.linalg.norm(np.cross(v1, v2), axis=-1)
            areas.append(a.reshape(-1))
    if not areas:
        raise ValueError("cartesian_background: mesh has no wall surfaces")
    area_avg = float(np.mean(np.concatenate(areas)))
    return lo, hi, np.sqrt(area_avg)


def _stretched_line(x0: float, x1: float, h: float, far: float,
                    stretch: float):
    """1-D node distribution: uniform spacing h over the core [x0, x1],
    geometrically stretched by ``stretch`` out to x0-far / x1+far."""
    n_core = max(int(np.ceil((x1 - x0) / h)), 2)
    core = np.linspace(x0, x1, n_core + 1)
    out_hi = [x1]
    d = h
    while out_hi[-1] < x1 + far:
        d *= stretch
        out_hi.append(out_hi[-1] + d)
    out_lo = [x0]
    d = h
    while out_lo[-1] > x0 - far:
        d *= stretch
        out_lo.append(out_lo[-1] - d)
    return np.concatenate([np.array(out_lo[::-1])[:-1], core,
                           np.array(out_hi)[1:]])


def cartesian_background(mesh: MultiBlockMesh,
                         scale: float = 2.5,
                         margin: float = 0.25,
                         far: Optional[float] = None,
                         stretch: float = 1.2,
                         name: str = "cart_bg",
                         sym_planes: Sequence[str] = ()
                         ) -> MultiBlockMesh:
    """Append an auto-generated Cartesian background block.

    * ``scale``  — background cell size = scale * sqrt(mean wall face
      area) (the reference's scaleSize on areaAvg).
    * ``margin`` — uniform-core margin around the wall bounding box, as a
      fraction of the bbox diagonal.
    * ``far``    — distance from the core to the far field (default: 10x
      the bbox diagonal).
    * ``sym_planes`` — e.g. ("zlow",): that face becomes a symmetry plane
      clipped AT the body bbox face instead of extending beyond
      (cartMesh.F90 symOnFace logic).
    """
    lo, hi, hwall = _wall_bbox_and_spacing(mesh)
    diag = float(np.linalg.norm(hi - lo))
    if diag <= 0:
        diag = max(hwall, 1.0)
    h = scale * hwall
    if far is None:
        far = 10.0 * diag
    pad = margin * diag
    lines = []
    sym = {s.lower() for s in sym_planes}
    for ax, axname in enumerate("xyz"):
        x0, x1 = lo[ax] - pad, hi[ax] + pad
        ln = _stretched_line(x0, x1, h, far, stretch)
        if f"{axname}low" in sym:
            ln = ln[ln >= x0 - 1e-12]
            ln[0] = lo[ax]
        if f"{axname}high" in sym:
            ln = ln[ln <= x1 + 1e-12]
            ln[-1] = hi[ax]
        lines.append(ln)
    x = np.stack(np.meshgrid(*lines, indexing="ij"), axis=-1)
    face_names = {0: "xlow", 1: "xhigh", 2: "ylow", 3: "yhigh",
                  4: "zlow", 5: "zhigh"}
    bcs = []
    for f in range(6):
        bc = (BCType.SYMMETRY if face_names[f] in sym
              else BCType.FARFIELD)
        fam = "sym" if bc is BCType.SYMMETRY else "far"
        bcs.append(BCSubface(face=Face(f), bc=bc, family=fam))
    bg = Block(name=name, x=x, bcs=bcs)
    return MultiBlockMesh(list(mesh.blocks) + [bg],
                          name=mesh.name or "overset")
