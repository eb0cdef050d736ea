# Frozen copy of adflow_torch/geom/metrics.py for the benchmark's reference, its
# imports made local.
"""Finite-volume metrics: face area vectors, volumes, cell centers
(counterpart of adflow_tpu/geom/metrics.py).

Face areas use the diagonal cross product (exact for bilinear faces);
volumes use the divergence theorem over the 6 faces, which telescopes so
block volumes sum exactly. Every function is a plain tensor expression, so
it stays differentiable w.r.t. node coordinates.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class BlockMetrics(NamedTuple):
    """Metrics for one block with ni x nj x nk cells (the JAX package's
    layout, adflow_tpu/geom/metrics.py:22-46).

    siE: (ni+3, nj+2, nk+2, 3)  +i-face area vectors on the one-ring
         extended grid (edge-replicated at physical boundaries)
    sjE: (ni+2, nj+3, nk+2, 3)
    skE: (ni+2, nj+2, nk+3, 3)
    vol: (ni+4, nj+4, nk+4) cell volumes, halo layers mirrored
    xc_ext: (ni+2, nj+2, nk+2, 3) cell centers on the one-ring extended
        grid; ghost centers mirrored across face centers
    vfIE/vfJE/vfKE: ALE grid-face velocity vectors on the same extended
        grids as siE/sjE/skE (``add_grid_motion``), or None for a static
        mesh; the fluxes use the normal face speed vf . S.
    """

    siE: torch.Tensor
    sjE: torch.Tensor
    skE: torch.Tensor
    vol: torch.Tensor
    xc_ext: torch.Tensor
    vfIE: object = None
    vfJE: object = None
    vfKE: object = None

    @property
    def si(self) -> torch.Tensor:
        """(ni+1, nj, nk, 3) interior i-face areas."""
        return self.siE[1:-1, 1:-1, 1:-1]

    @property
    def sj(self) -> torch.Tensor:
        return self.sjE[1:-1, 1:-1, 1:-1]

    @property
    def sk(self) -> torch.Tensor:
        return self.skE[1:-1, 1:-1, 1:-1]

    @property
    def vfI(self):
        return None if self.vfIE is None else self.vfIE[1:-1, 1:-1, 1:-1]

    @property
    def vfJ(self):
        return None if self.vfJE is None else self.vfJE[1:-1, 1:-1, 1:-1]

    @property
    def vfK(self):
        return None if self.vfKE is None else self.vfKE[1:-1, 1:-1, 1:-1]


def pad_like_numpy(a: torch.Tensor, width: int, mode: str, axes=(0, 1, 2)):
    """``np.pad(a, width, mode)`` over ``axes`` ('edge' or 'symmetric'),
    done as an index gather so it is exact and differentiable."""
    for ax in axes:
        idx = np.pad(np.arange(a.shape[ax]), width, mode=mode)
        a = torch.index_select(a, ax, torch.as_tensor(idx, device=a.device))
    return a


def _quad_area(x00, x10, x11, x01):
    """0.5 * (x11-x00) x (x01-x10): area vector of a bilinear quad whose
    corners are ordered counterclockwise seen from the +normal side."""
    return 0.5 * torch.linalg.cross(x11 - x00, x01 - x10, dim=-1)


def face_areas(x: torch.Tensor):
    """Face area vectors (si, sj, sk) from nodes x: (ni+1, nj+1, nk+1, 3).

    Orientation: si points in +i, sj in +j, sk in +k (right-handed blocks).
    """
    si = _quad_area(
        x[:, :-1, :-1], x[:, 1:, :-1], x[:, 1:, 1:], x[:, :-1, 1:])
    sj = _quad_area(
        x[:-1, :, :-1], x[:-1, :, 1:], x[1:, :, 1:], x[1:, :, :-1])
    sk = _quad_area(
        x[:-1, :-1, :], x[1:, :-1, :], x[1:, 1:, :], x[:-1, 1:, :])
    return si, sj, sk


def face_centers(x: torch.Tensor):
    """Face centroids (mean of 4 corner nodes) for i/j/k faces."""
    xmi = 0.25 * (x[:, :-1, :-1] + x[:, 1:, :-1] + x[:, 1:, 1:] + x[:, :-1, 1:])
    xmj = 0.25 * (x[:-1, :, :-1] + x[:-1, :, 1:] + x[1:, :, 1:] + x[1:, :, :-1])
    xmk = 0.25 * (x[:-1, :-1, :] + x[1:, :-1, :] + x[1:, 1:, :] + x[:-1, 1:, :])
    return xmi, xmj, xmk


def cell_volumes(x: torch.Tensor):
    """Cell volumes via the divergence theorem: V = (1/3) sum_f xc_f . S_f."""
    si, sj, sk = face_areas(x)
    xmi, xmj, xmk = face_centers(x)

    def fdot(xm, s):
        return torch.sum(xm * s, dim=-1)

    return (
        fdot(xmi[1:], si[1:]) - fdot(xmi[:-1], si[:-1])
        + fdot(xmj[:, 1:], sj[:, 1:]) - fdot(xmj[:, :-1], sj[:, :-1])
        + fdot(xmk[:, :, 1:], sk[:, :, 1:]) - fdot(xmk[:, :, :-1], sk[:, :, :-1])
    ) / 3.0


def cell_centers(x: torch.Tensor):
    """Cell centroids (mean of 8 corner nodes)."""
    return 0.125 * (
        x[:-1, :-1, :-1] + x[1:, :-1, :-1] + x[:-1, 1:, :-1] + x[:-1, :-1, 1:]
        + x[1:, 1:, :-1] + x[1:, :-1, 1:] + x[:-1, 1:, 1:] + x[1:, 1:, 1:])


def _cell_centers_ext(x: torch.Tensor) -> torch.Tensor:
    """Cell centers padded by one ghost ring whose positions are the
    interior centers mirrored across the boundary face centers."""
    xc = cell_centers(x)
    xmi, xmj, xmk = face_centers(x)

    def pad_axis(a, fc, ax):
        first = a.narrow(ax, 0, 1)
        last = a.narrow(ax, a.shape[ax] - 1, 1)
        f_lo = fc.narrow(ax, 0, 1)
        f_hi = fc.narrow(ax, fc.shape[ax] - 1, 1)
        return torch.cat([2.0 * f_lo - first, a, 2.0 * f_hi - last], dim=ax)

    xc = pad_axis(xc, xmi, 0)
    xc = pad_axis(xc, pad_like_numpy(xmj, 1, "edge", (0,)), 1)
    xc = pad_axis(xc, pad_like_numpy(xmk, 1, "edge", (0, 1)), 2)
    return xc


def compute_metrics(x: torch.Tensor) -> BlockMetrics:
    """All metrics for one block. Halo volumes are mirrored from the interior
    and halo faces edge-replicated."""
    si, sj, sk = face_areas(x)
    vol = pad_like_numpy(cell_volumes(x), 2, "symmetric")
    return BlockMetrics(
        siE=pad_like_numpy(si, 1, "edge"),
        sjE=pad_like_numpy(sj, 1, "edge"),
        skE=pad_like_numpy(sk, 1, "edge"),
        vol=vol, xc_ext=_cell_centers_ext(x))


def rigid_velocity(points, omega, center, vtrans):
    """v(x) = omega x (x - center) + vtrans for rigid-body grid motion
    (reference gridVelocitiesFineLevel, solverUtils.F90:358). ``omega``,
    ``center`` and ``vtrans`` are 3-vectors: sequences or tensors (the
    adjoint's design variables), kept in the graph."""
    kw = dict(dtype=points.dtype, device=points.device)
    om = torch.as_tensor(omega, **kw)
    c = torch.as_tensor(center, **kw)
    vt = torch.as_tensor(vtrans, **kw)
    return torch.linalg.cross(om.expand(points.shape), points - c,
                              dim=-1) + vt


def add_grid_motion(metrics: BlockMetrics, x: torch.Tensor, omega,
                    center=(0.0, 0.0, 0.0), vtrans=(0.0, 0.0, 0.0)
                    ) -> BlockMetrics:
    """Attach rigid-motion face velocities to a block's metrics.

    Face velocities are evaluated at face centroids (the points the volume
    formula integrates), so for rigid motion the discrete velocity
    divergence telescopes to round-off per cell and the free stream is
    preserved (the ALE GCL, reference src/solver/ALEUtils.F90).
    """
    def vf(xm):
        return pad_like_numpy(rigid_velocity(xm, omega, center, vtrans), 1,
                              "edge")

    xmi, xmj, xmk = face_centers(x)
    return metrics._replace(vfIE=vf(xmi), vfJE=vf(xmj), vfKE=vf(xmk))


# ---------------------------------------------------------------------------
# True halo metrics at b2b connections (the ghost ring of siE/sjE/skE/vol/
# xc_ext carries the neighbor's real geometry instead of edge replication —
# the O-mesh wake cut of wing_omesh is such a connection).
# ---------------------------------------------------------------------------

def extend_nodes_list(blocks, x_list):
    """Per-block node arrays extended by ONE ghost node layer per side:
    (ni+3, nj+3, nk+3, 3). Base fill: linear extrapolation; b2b connection
    faces overwritten with the donor block's true nodes. Rotated/translated
    periodic connections keep the extrapolated fill."""

    def extrap_pad(x):
        for ax in range(3):
            n = x.shape[ax]
            lo = 2.0 * x.narrow(ax, 0, 1) - x.narrow(ax, 1, 1)
            hi = 2.0 * x.narrow(ax, n - 1, 1) - x.narrow(ax, n - 2, 1)
            x = torch.cat([lo, x, hi], dim=ax)
        return x

    out = [extrap_pad(x) for x in x_list]
    # two passes, reading from the (partially) extended donor arrays, so
    # corner/edge ghosts pick up values another connection delivered
    for _ in range(2):
        nxt = list(out)
        for bi, blk in enumerate(blocks):
            dims = tuple(s - 1 for s in blk.x.shape[:3])
            for conn in blk.conns:
                if conn.rotation is not None or conn.translation is not None:
                    continue
                ax = conn.face.axis
                donor = blocks[conn.donor_block]
                ddims = tuple(s - 1 for s in donor.x.shape[:3])
                t_axes = [a for a in range(3) if a != ax]
                rngs = []
                for m in range(3):
                    if m == ax:
                        rngs.append(np.array(
                            [dims[ax] + 1 if conn.face.is_high else -1]))
                    else:
                        rlo, rhi = ((0, dims[m]) if conn.rng is None
                                    else conn.rng[t_axes.index(m)])
                        nlo = rlo - 1 if rlo == 0 else rlo
                        nhi = rhi + 2 if rhi == dims[m] else rhi + 1
                        rngs.append(np.arange(nlo, nhi))
                g = np.stack(np.meshgrid(*rngs, indexing="ij"), axis=-1)
                d = np.zeros_like(g)
                for m in range(3):
                    t = conn.transform[m]
                    a_d = abs(t) - 1
                    if t > 0:
                        d[..., a_d] = g[..., m] + conn.offset[m]
                    else:
                        d[..., a_d] = conn.offset[m] + 1 - g[..., m]
                for m in range(3):
                    d[..., m] = np.clip(d[..., m] + 1, 0, ddims[m] + 2)
                gi = g + 1
                dev = out[bi].device
                di = [torch.as_tensor(d[..., m], device=dev) for m in range(3)]
                gg = [torch.as_tensor(gi[..., m], device=dev) for m in range(3)]
                src = out[conn.donor_block][di[0], di[1], di[2]]
                upd = nxt[bi].clone()
                upd[gg[0], gg[1], gg[2]] = src
                nxt[bi] = upd
        out = nxt
    return out


def compute_metrics_conn(blocks, x_list):
    """compute_metrics per block, with the ghost-ring metric entries at b2b
    connection faces replaced by TRUE values computed from exchanged halo
    nodes. Conn-free blocks are identical to compute_metrics."""
    x_ext_list = extend_nodes_list(blocks, x_list)
    out = []
    for bi, blk in enumerate(blocks):
        base = compute_metrics(x_list[bi])
        conns = [c for c in blk.conns
                 if c.rotation is None and c.translation is None]
        if not conns:
            out.append(base)
            continue
        xe = x_ext_list[bi]
        fsi, fsj, fsk = face_areas(xe)
        fvol = cell_volumes(xe)
        fxc = cell_centers(xe)
        siE, sjE, skE = base.siE, base.sjE, base.skE
        vol, xc = base.vol, base.xc_ext

        def set_plane(a, full, axis, hi, vol_style=False):
            idx = (a.shape[axis] - (2 if vol_style else 1)) if hi \
                else (1 if vol_style else 0)
            fidx = full.shape[axis] - 1 if hi else 0
            sl = [slice(None)] * a.ndim
            sl[axis] = idx
            fsl = [slice(None)] * full.ndim
            fsl[axis] = fidx
            if vol_style:
                # base vol is two-ring padded (n+4): embed the one-ring
                # plane into the central tangential region
                for t in range(3):
                    if t != axis:
                        sl[t] = slice(1, -1)
            a = a.clone()
            a[tuple(sl)] = full[tuple(fsl)]
            return a

        done = set()
        for c in conns:
            key = (c.face.axis, c.face.is_high)
            if key in done:
                continue
            done.add(key)
            ax, hi = key
            siE = set_plane(siE, fsi, ax, hi)
            sjE = set_plane(sjE, fsj, ax, hi)
            skE = set_plane(skE, fsk, ax, hi)
            vol = set_plane(vol, fvol, ax, hi, vol_style=True)
            xc = set_plane(xc, fxc, ax, hi)
        out.append(BlockMetrics(siE=siE, sjE=sjE, skE=skE, vol=vol,
                                xc_ext=xc))
    return out
