"""Mesh quality diagnostics (counterpart of adflow_tpu/geom/quality.py,
numpy).

Reference analogue: `src/partitioning/gridChecking.F90`
(1,329 LoC) — negative-volume / left-handedness detection and quality
metrics reported at startup, plus the skewness unit test
(`tests/unit_tests/test_mesh_skewness.py`). Warped-mesh design loops need
these to detect inverted or degenerate cells before the solver NaNs.

Metrics (host-side numpy; one-shot diagnostics, not the hot path):

* ``volume``     — hexahedron volumes via the divergence theorem (same
  discrete form as geom/metrics.py, so "negative volume" here means the
  solver's own metric is negative).
* ``sub_jacobians`` — the 8 corner tetrahedron Jacobians per cell; a sign
  change inside one cell = twisted (locally inverted) hex that can have
  positive total volume.
* ``skewness``   — 1 - cos(angle between each face normal and the
  neighboring cell-center line); 0 = orthogonal grid.
* ``aspect``     — max/min of the three directional edge lengths.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np


def _corners(x: np.ndarray):
    """(ni, nj, nk, 8, 3) hex corners in the Fortran CGNS ordering."""
    c = np.empty(tuple(d - 1 for d in x.shape[:3]) + (8, 3), x.dtype)
    k = 0
    for dk in (0, 1):
        for dj in (0, 1):
            for di in (0, 1):
                c[..., k, :] = x[di:x.shape[0] - 1 + di,
                                 dj:x.shape[1] - 1 + dj,
                                 dk:x.shape[2] - 1 + dk]
                k += 1
    return c


def cell_quality(x: np.ndarray) -> Dict[str, np.ndarray]:
    """Quality arrays for one block of nodes (ni+1, nj+1, nk+1, 3)."""
    x = np.asarray(x, float)
    c = _corners(x)
    # corner ordering above: index bit0 = i, bit1 = j, bit2 = k
    e_i = [(0, 1), (2, 3), (4, 5), (6, 7)]
    e_j = [(0, 2), (1, 3), (4, 6), (5, 7)]
    e_k = [(0, 4), (1, 5), (2, 6), (3, 7)]

    def edge_len(pairs):
        return np.mean([np.linalg.norm(c[..., b, :] - c[..., a, :],
                                       axis=-1) for a, b in pairs], axis=0)

    li, lj, lk = edge_len(e_i), edge_len(e_j), edge_len(e_k)
    lens = np.stack([li, lj, lk], axis=-1)
    lmax = lens.max(axis=-1)
    lmin = np.maximum(lens.min(axis=-1), 1e-300)
    aspect = lmax / lmin

    # 8 corner Jacobians: det of the 3 edges leaving each corner
    jac = np.empty(c.shape[:3] + (8,))
    for k in range(8):
        io = k ^ 1          # flip i bit
        jo = k ^ 2
        ko = k ^ 4
        sgn = ((-1) ** (k & 1)) * ((-1) ** ((k >> 1) & 1)) \
            * ((-1) ** ((k >> 2) & 1))
        a = c[..., io, :] - c[..., k, :]
        b = c[..., jo, :] - c[..., k, :]
        d = c[..., ko, :] - c[..., k, :]
        jac[..., k] = sgn * np.einsum("...i,...i->...",
                                      np.cross(a, b), d)

    # volume diagnostic: mean of the 8 corner Jacobians (exact for
    # parallelepipeds, O(h^2)-accurate for general trilinear hexes —
    # adequate for sign/size diagnostics; the solver's own metric volume
    # lives in geom/metrics.py)
    vol = jac.mean(axis=-1)

    # skewness on interior faces along each axis
    cc = c.mean(axis=3)                      # cell centers
    skew = np.zeros(vol.shape)
    for ax in range(3):
        # face normal between cell (.,) and its +ax neighbor
        sl_lo = [slice(None)] * 3
        sl_hi = [slice(None)] * 3
        sl_lo[ax] = slice(0, -1)
        sl_hi[ax] = slice(1, None)
        d = cc[tuple(sl_hi)] - cc[tuple(sl_lo)]
        # face between the two cells: nodes at index i+1 along ax
        nsl = [slice(None)] * 3
        nsl[ax] = slice(1, -1)
        t1, t2 = [a for a in range(3) if a != ax]
        fa = x[tuple(nsl)]

        def sh(arr, axis, off):
            s = [slice(None)] * arr.ndim
            s[axis] = slice(off, arr.shape[axis] - 1 + off)
            return arr[tuple(s)]

        p00 = sh(sh(fa, t1, 0), t2, 0)
        p10 = sh(sh(fa, t1, 1), t2, 0)
        p11 = sh(sh(fa, t1, 1), t2, 1)
        p01 = sh(sh(fa, t1, 0), t2, 1)
        n = 0.5 * np.cross(p11 - p00, p01 - p10)
        nn = np.linalg.norm(n, axis=-1) * np.linalg.norm(d, axis=-1)
        cosang = np.abs(np.einsum("...i,...i->...", n, d)) \
            / np.maximum(nn, 1e-300)
        s = 1.0 - cosang
        # accumulate the worst face skewness onto both adjacent cells
        skew[tuple(sl_lo)] = np.maximum(skew[tuple(sl_lo)], s)
        skew[tuple(sl_hi)] = np.maximum(skew[tuple(sl_hi)], s)

    return {"volume": vol, "sub_jacobians": jac, "skewness": skew,
            "aspect": aspect}


def check_mesh_quality(mesh, x_list=None) -> Dict[str, object]:
    """Whole-mesh quality report (gridChecking.F90 blockCheck analogue).

    Returns counts + extrema; ``ok`` is False when any cell is inverted
    (negative volume) or twisted (corner-Jacobian sign change)."""
    n_neg_vol = 0
    n_twisted = 0
    min_vol = np.inf
    max_skew = 0.0
    max_aspect = 0.0
    per_block: List[dict] = []
    for bi, b in enumerate(mesh.blocks):
        x = (np.asarray(x_list[bi], float) if x_list is not None
             else np.asarray(b.x, float))
        q = cell_quality(x)
        neg = int((q["volume"] <= 0.0).sum())
        jmin = q["sub_jacobians"].min(axis=-1)
        jmax = q["sub_jacobians"].max(axis=-1)
        twisted = int(((jmin < 0.0) & (jmax > 0.0)).sum())
        n_neg_vol += neg
        n_twisted += twisted
        min_vol = min(min_vol, float(q["volume"].min()))
        max_skew = max(max_skew, float(q["skewness"].max()))
        max_aspect = max(max_aspect, float(q["aspect"].max()))
        per_block.append({
            "block": b.name or str(bi), "n_negative_volumes": neg,
            "n_twisted": twisted, "min_volume": float(q["volume"].min()),
            "max_skewness": float(q["skewness"].max()),
            "max_aspect_ratio": float(q["aspect"].max())})
    return {"ok": n_neg_vol == 0 and n_twisted == 0,
            "n_negative_volumes": n_neg_vol, "n_twisted_cells": n_twisted,
            "min_volume": float(min_vol), "max_skewness": max_skew,
            "max_aspect_ratio": max_aspect, "blocks": per_block}
