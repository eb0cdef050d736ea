"""Overset (chimera) connectivity: hole cutting, donor search, interpolation
(counterpart of adflow_tpu/overset/assembly.py).

Reference analogue: ``oversetComm`` (src/overset/oversetAPI.F90:7, Steps
1-16): bounding boxes, ADT donor searches (src/ADT/adtLocalSearch.F90),
fringe/donor selection by cell quality, interior flooding, and the final
interpolation comm structures, with the ``iblank`` array (compute=1,
fringe=-1, hole=0) consumed by every kernel. Explicit hole-cut callbacks
mirror ``pyADflow.py:4370 _oversetCutCallback``.

All the irregular work (cluster identification, hole cutting, containment
searches, trilinear weights) happens once on the host in NumPy/SciPy and
produces static gather tables, the same arrays as the JAX package's.
``device_table`` moves their indices and weights to the solver's device and
dtype once; at run time ``apply_overset`` is a gather, a contraction and an
out-of-place scatter per group, differentiable through ``torch.func``
(the weights are constants; values flow through the vjp, the reference's
interpolate-on-the-send-side rule, communication.F90:17-21).

Donor interpolation is trilinear on the *dual* grid of cell centers, with
trilinear coordinates from Newton inversion of the dual-brick map. Donor
quality = smallest donor-cell volume. Receivers with no containing donor
average their compute face neighbours (orphanAverage,
utils/haloExchange.F90:201), or, with none, are clamped to the nearest
brick.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

try:
    from scipy.spatial import cKDTree
except ImportError:  # pragma: no cover
    cKDTree = None

from adflow_torch.core.mesh import BCType, Face, MultiBlockMesh

H = 2

IBLANK_COMPUTE = 1
IBLANK_FRINGE = -1
IBLANK_HOLE = 0


@dataclasses.dataclass(frozen=True)
class OversetGroup:
    """All fringe cells of one receiver block interpolated from one donor
    block: one gather + one scatter at runtime."""

    dst_block: int
    src_block: int
    dst_flat: np.ndarray      # (n,) into dst's halo-padded flat cell space
    src_flat: np.ndarray      # (8, n) into src's halo-padded flat cell space
    weights: np.ndarray       # (8, n) trilinear weights, sum to 1
    # interior-fringe groups (priority 0) apply before ghost-receiver groups
    # (priority 1) so ghosts read fresh fringe donors; deeper fringe-chains
    # converge via the solver's outer iterations (the reference topologically
    # sorts fringe-donor chains instead, oversetAPI.F90 fringe sorting)
    priority: int = 1


@dataclasses.dataclass(frozen=True)
class OversetTable:
    """Static overset connectivity (per MG level)."""

    groups: Tuple[OversetGroup, ...]
    iblank: Tuple[np.ndarray, ...]   # per block, (ni, nj, nk) int8
    n_orphans: int = 0


def _cell_centers(x: np.ndarray) -> np.ndarray:
    """(ni, nj, nk, 3) interior cell centers from (ni+1, nj+1, nk+1, 3)."""
    c = 0.125 * (x[:-1, :-1, :-1] + x[1:, :-1, :-1] + x[:-1, 1:, :-1]
                 + x[:-1, :-1, 1:] + x[1:, 1:, :-1] + x[1:, :-1, 1:]
                 + x[:-1, 1:, 1:] + x[1:, 1:, 1:])
    return c


def _padded_centers(x: np.ndarray) -> np.ndarray:
    """Halo-padded cell centers, ghosts linearly extrapolated along each
    axis (ghost centers only feed receiver *positions*, never donors)."""
    c = _cell_centers(x)
    for ax in range(3):
        lo1 = 2 * np.take(c, [0], ax) - np.take(c, [1], ax)
        lo2 = 2 * lo1 - np.take(c, [0], ax)
        hi1 = 2 * np.take(c, [-1], ax) - np.take(c, [-2], ax)
        hi2 = 2 * hi1 - np.take(c, [-1], ax)
        c = np.concatenate([lo2, lo1, c, hi1, hi2], axis=ax)
    return c


def _cell_volumes(x: np.ndarray) -> np.ndarray:
    """Approximate interior cell volumes (parallelepiped of edge midlines) —
    only used as the donor-quality metric, not in the discretization."""
    e1 = x[1:, :-1, :-1] - x[:-1, :-1, :-1]
    e2 = x[:-1, 1:, :-1] - x[:-1, :-1, :-1]
    e3 = x[:-1, :-1, 1:] - x[:-1, :-1, :-1]
    return np.abs(np.einsum("...i,...i->...", np.cross(e1, e2), e3))


def _clusters(mesh: MultiBlockMesh) -> np.ndarray:
    """Union-find over 1-to-1 connections: blocks joined by b2b matches form
    one overset 'cluster' (reference: buildClusterWalls.F90 cluster ids)."""
    parent = list(range(len(mesh.blocks)))

    def find(a):
        while parent[a] != a:
            parent[a] = parent[parent[a]]
            a = parent[a]
        return a

    for bi, b in enumerate(mesh.blocks):
        for c in b.conns:
            ra, rb = find(bi), find(c.donor_block)
            if ra != rb:
                parent[ra] = rb
    return np.array([find(i) for i in range(len(mesh.blocks))])


def _trilinear_invert(corners: np.ndarray, p: np.ndarray, iters: int = 12):
    """Newton-invert the trilinear map of dual bricks.

    corners: (n, 2, 2, 2, 3) brick corner coordinates; p: (n, 3) targets.
    Returns (uvw (n,3), ok (n,) containment with small tolerance).
    """
    n = len(p)
    u = np.full((n, 3), 0.5)
    c = corners
    for _ in range(iters):
        a, b, g = u[:, 0:1], u[:, 1:2], u[:, 2:3]
        w000 = (1 - a) * (1 - b) * (1 - g)
        w100 = a * (1 - b) * (1 - g)
        w010 = (1 - a) * b * (1 - g)
        w001 = (1 - a) * (1 - b) * g
        w110 = a * b * (1 - g)
        w101 = a * (1 - b) * g
        w011 = (1 - a) * b * g
        w111 = a * b * g
        pos = (w000 * c[:, 0, 0, 0] + w100 * c[:, 1, 0, 0]
               + w010 * c[:, 0, 1, 0] + w001 * c[:, 0, 0, 1]
               + w110 * c[:, 1, 1, 0] + w101 * c[:, 1, 0, 1]
               + w011 * c[:, 0, 1, 1] + w111 * c[:, 1, 1, 1])
        r = pos - p
        # Jacobian d pos / d u  (a1/b1/g1: flat (n,) for clean broadcasting)
        a1, b1, g1 = u[:, 0], u[:, 1], u[:, 2]

        def _w(t):
            return t[:, None]

        du = _w((1 - b1) * (1 - g1)) * (c[:, 1, 0, 0] - c[:, 0, 0, 0]) \
            + _w(b1 * (1 - g1)) * (c[:, 1, 1, 0] - c[:, 0, 1, 0]) \
            + _w((1 - b1) * g1) * (c[:, 1, 0, 1] - c[:, 0, 0, 1]) \
            + _w(b1 * g1) * (c[:, 1, 1, 1] - c[:, 0, 1, 1])
        dv = _w((1 - a1) * (1 - g1)) * (c[:, 0, 1, 0] - c[:, 0, 0, 0]) \
            + _w(a1 * (1 - g1)) * (c[:, 1, 1, 0] - c[:, 1, 0, 0]) \
            + _w((1 - a1) * g1) * (c[:, 0, 1, 1] - c[:, 0, 0, 1]) \
            + _w(a1 * g1) * (c[:, 1, 1, 1] - c[:, 1, 0, 1])
        dg = _w((1 - a1) * (1 - b1)) * (c[:, 0, 0, 1] - c[:, 0, 0, 0]) \
            + _w(a1 * (1 - b1)) * (c[:, 1, 0, 1] - c[:, 1, 0, 0]) \
            + _w((1 - a1) * b1) * (c[:, 0, 1, 1] - c[:, 0, 1, 0]) \
            + _w(a1 * b1) * (c[:, 1, 1, 1] - c[:, 1, 1, 0])
        J = np.stack([du, dv, dg], axis=-1)   # (n, 3, 3)
        try:
            step = np.linalg.solve(J, r[..., None])[..., 0]
        except np.linalg.LinAlgError:
            step = np.zeros_like(r)
        u = u - step
    tol = 1e-6
    ok = np.all((u > -tol) & (u < 1 + tol), axis=1)
    return u, ok


def _tri_weights(u: np.ndarray) -> np.ndarray:
    """(n, 3) local coords -> (8, n) weights in (i, j, k) bit order
    [000,100,010,110,001,101,011,111]."""
    a, b, g = u[:, 0], u[:, 1], u[:, 2]
    return np.stack([
        (1 - a) * (1 - b) * (1 - g), a * (1 - b) * (1 - g),
        (1 - a) * b * (1 - g), a * b * (1 - g),
        (1 - a) * (1 - b) * g, a * (1 - b) * g,
        (1 - a) * b * g, a * b * g])


def build_overset(mesh: MultiBlockMesh,
                  cut_callback: Optional[Callable] = None,
                  padded_shapes: Optional[Sequence[Tuple[int, ...]]] = None
                  ) -> Optional[OversetTable]:
    """Assemble the overset connectivity.

    cut_callback(block_index, centers (n,3)) -> bool mask of HOLE cells —
    the explicit-cut path (pyADflow _oversetCutCallback). Fringes are (a) the
    two ghost layers behind every BCType.OVERSET subface and (b) the 2-cell
    ring of interior cells around holes. Donors come from blocks in a
    *different* cluster, best (finest) containing donor wins.
    """
    nb = len(mesh.blocks)
    has_overset = any(sf.bc is BCType.OVERSET
                      for b in mesh.blocks for sf in b.bcs)
    if not has_overset and cut_callback is None:
        return None
    if cKDTree is None:  # pragma: no cover
        raise RuntimeError("scipy required for overset assembly")

    clusters = _clusters(mesh)
    centers = [_cell_centers(b.x) for b in mesh.blocks]
    pcenters = [_padded_centers(b.x) for b in mesh.blocks]
    vols = [_cell_volumes(b.x) for b in mesh.blocks]
    trees = [cKDTree(c.reshape(-1, 3)) for c in centers]
    dims = [b.dims for b in mesh.blocks]
    if padded_shapes is None:
        padded_shapes = [tuple(d + 2 * H for d in dm) for dm in dims]

    # --- 1. holes (explicit cut, or IMPLICIT wall-containment + flood when
    # no callback is given — oversetAPI.F90 implicit hole cutting) ---------
    iblank = [np.full(dm, IBLANK_COMPUTE, np.int8) for dm in dims]
    if cut_callback is not None:
        for bi in range(nb):
            mask = np.asarray(
                cut_callback(bi, centers[bi].reshape(-1, 3)), bool)
            iblank[bi][mask.reshape(dims[bi])] = IBLANK_HOLE
    elif len(set(int(c) for c in clusters)) >= 2:
        for bi, hole in enumerate(implicit_hole_cut(mesh, clusters,
                                                    centers)):
            iblank[bi][hole] = IBLANK_HOLE

    # --- 2. fringe sets ----------------------------------------------------
    # (a) interior ring around holes: dilate the hole mask by 2 cells.
    for bi in range(nb):
        hole = iblank[bi] == IBLANK_HOLE
        if not hole.any():
            continue
        near = hole.copy()
        for _ in range(H):
            p = np.pad(near, 1, constant_values=False)
            near = (p[1:-1, 1:-1, 1:-1]
                    | p[:-2, 1:-1, 1:-1] | p[2:, 1:-1, 1:-1]
                    | p[1:-1, :-2, 1:-1] | p[1:-1, 2:, 1:-1]
                    | p[1:-1, 1:-1, :-2] | p[1:-1, 1:-1, 2:])
        fr = near & ~hole
        iblank[bi][fr] = IBLANK_FRINGE

    # receiver points: (block, cell-coords-in-padded-frame, xyz)
    recv_blk: List[int] = []
    recv_pad3: List[np.ndarray] = []
    recv_xyz: List[np.ndarray] = []

    for bi in range(nb):
        fr = np.argwhere(iblank[bi] == IBLANK_FRINGE)
        if len(fr):
            recv_blk += [bi] * len(fr)
            recv_pad3.append(fr + H)
            recv_xyz.append(centers[bi][tuple(fr.T)])
        # (b) overset outer-boundary ghost cells
        for sf in mesh.blocks[bi].bcs:
            if sf.bc is not BCType.OVERSET:
                continue
            ax = sf.face.axis
            t1, t2 = [a for a in range(3) if a != ax]
            rng = sf.rng or ((0, dims[bi][t1]), (0, dims[bi][t2]))
            rr = [None, None, None]
            rr[ax] = (np.arange(dims[bi][ax], dims[bi][ax] + H)
                      if sf.face.is_high else np.arange(-H, 0))
            rr[t1] = np.arange(rng[0][0], rng[0][1])
            rr[t2] = np.arange(rng[1][0], rng[1][1])
            g = np.stack(np.meshgrid(*rr, indexing="ij"), -1).reshape(-1, 3)
            recv_blk += [bi] * len(g)
            recv_pad3.append(g + H)
            recv_xyz.append(pcenters[bi][tuple((g + H).T)])

    if not recv_blk:
        return OversetTable(groups=(), iblank=tuple(iblank))

    recv_blk = np.asarray(recv_blk)
    recv_pad3 = np.concatenate(recv_pad3, axis=0)
    recv_xyz = np.concatenate(recv_xyz, axis=0)
    nrecv = len(recv_blk)

    # --- 3. donor search ---------------------------------------------------
    best_q = np.full(nrecv, np.inf)
    best_src = np.full(nrecv, -1, np.int64)
    best_anchor = np.zeros((nrecv, 3), np.int64)
    best_uvw = np.zeros((nrecv, 3))
    contained = np.zeros(nrecv, bool)

    for dbi in range(nb):
        cand = np.flatnonzero(clusters[recv_blk] != clusters[dbi])
        if len(cand) == 0:
            continue
        p = recv_xyz[cand]
        dni, dnj, dnk = dims[dbi]
        if min(dni, dnj, dnk) < 2:
            continue
        _, nearest = trees[dbi].query(p)
        n3 = np.stack(np.unravel_index(nearest, dims[dbi]), axis=1)
        c = centers[dbi]
        # try the 8 dual bricks around the nearest center; keep the best
        loc_ok = np.zeros(len(cand), bool)
        loc_u = np.full((len(cand), 3), 0.5)
        loc_anchor = np.zeros((len(cand), 3), np.int64)
        loc_miss = np.full(len(cand), np.inf)  # distance-outside metric
        for di in (-1, 0):
            for dj in (-1, 0):
                for dk in (-1, 0):
                    a = n3 + np.array([di, dj, dk])
                    a = np.clip(a, 0, np.array(dims[dbi]) - 2)
                    corners = np.empty((len(cand), 2, 2, 2, 3))
                    for oi in (0, 1):
                        for oj in (0, 1):
                            for ok_ in (0, 1):
                                corners[:, oi, oj, ok_] = c[
                                    a[:, 0] + oi, a[:, 1] + oj, a[:, 2] + ok_]
                    u, inb = _trilinear_invert(corners, p)
                    miss = np.maximum(np.maximum(-u, u - 1), 0).sum(axis=1)
                    better = (inb & ~loc_ok) | (
                        (inb == loc_ok) & (miss < loc_miss))
                    loc_ok |= inb
                    loc_u[better] = u[better]
                    loc_anchor[better] = a[better]
                    loc_miss[better] = miss[better]
        # donor-hole exclusion: any brick cell that is a hole invalidates
        ib = iblank[dbi]
        a = loc_anchor
        brickmin = np.ones(len(cand), np.int8)
        for oi in (0, 1):
            for oj in (0, 1):
                for ok_ in (0, 1):
                    brickmin = np.minimum(
                        brickmin,
                        ib[a[:, 0] + oi, a[:, 1] + oj, a[:, 2] + ok_])
        valid = loc_ok & (brickmin != IBLANK_HOLE)
        q = vols[dbi][a[:, 0], a[:, 1], a[:, 2]]
        # a contained donor always beats an uncontained one; among contained,
        # smallest volume (finest grid) wins.
        gi = cand
        upgrade = (valid & ~contained[gi]) | (
            valid & contained[gi] & (q < best_q[gi]))
        idx = gi[upgrade]
        best_q[idx] = q[upgrade]
        best_src[idx] = dbi
        best_anchor[idx] = a[upgrade]
        best_uvw[idx] = np.clip(loc_u[upgrade], 0.0, 1.0)
        contained[idx] = True
        # orphan fallback: remember SOME donor even if not contained
        fallback = (~contained[gi]) & (best_src[gi] < 0)
        idx = gi[fallback]
        best_src[idx] = dbi
        best_anchor[idx] = a[fallback]
        best_uvw[idx] = np.clip(loc_u[fallback], 0.0, 1.0)

    n_orphans = int((~contained).sum())

    # --- orphan treatment (reference: orphanAverage,
    # utils/haloExchange.F90:201): a fringe with no containing donor gets
    # the AVERAGE of its valid compute face-neighbors instead of a badly
    # extrapolated clamped-brick interpolation; the clamped fallback
    # remains only for orphans with no valid neighbor at all.
    orphan_groups: List[tuple] = []   # (bi, dst_flat, src_flats, weights)
    orphan_sel = np.flatnonzero(~contained & (best_src >= 0))
    drop = np.zeros(len(recv_blk), bool)
    offsets = np.array([[1, 0, 0], [-1, 0, 0], [0, 1, 0],
                        [0, -1, 0], [0, 0, 1], [0, 0, -1]])
    for r in orphan_sel:
        bi = int(recv_blk[r])
        p3 = recv_pad3[r]
        ib = iblank[bi]
        ni, nj, nk = dims[bi]
        srcs = []
        for off in offsets:
            q = p3 + off
            qi = q - H
            if np.all(qi >= 0) and np.all(qi < [ni, nj, nk]) \
                    and ib[qi[0], qi[1], qi[2]] == IBLANK_COMPUTE:
                ps = padded_shapes[bi]
                srcs.append((q[0] * ps[1] + q[1]) * ps[2] + q[2])
        if srcs:
            ps = padded_shapes[bi]
            dflat = (p3[0] * ps[1] + p3[1]) * ps[2] + p3[2]
            # pad to 8 sources (group layout); zero weight on the padding
            n_valid = len(srcs)
            wgt = np.zeros(8)
            wgt[:n_valid] = 1.0 / n_valid
            while len(srcs) < 8:
                srcs.append(srcs[0])
            orphan_groups.append((bi, dflat, srcs, wgt))
            drop[r] = True

    keep = (best_src >= 0) & ~drop
    recv_blk, recv_pad3 = recv_blk[keep], recv_pad3[keep]
    best_src, best_anchor = best_src[keep], best_anchor[keep]
    best_uvw = best_uvw[keep]

    # --- 4. compile (dst, src) groups --------------------------------------
    # Groups are split by receiver class: interior-fringe receivers
    # (priority 0) apply before ghost receivers (priority 1), so ghost
    # interpolation reads fresh interior-fringe donor values. Chains deeper
    # than interior->ghost (fringe reading another block's fringe donor)
    # still resolve through the outer fixed-point iterations of the solve.
    groups: List[OversetGroup] = []
    for bi in range(nb):
        for dbi in range(nb):
            pair = np.flatnonzero((recv_blk == bi) & (best_src == dbi))
            if len(pair) == 0:
                continue
            ps_d, ps_r = padded_shapes[dbi], padded_shapes[bi]
            ni, nj, nk = dims[bi]
            p3_all = recv_pad3[pair]
            interior = np.all(
                (p3_all >= H) & (p3_all < np.array([ni, nj, nk]) + H), axis=1)
            for prio, msel in ((0, interior), (1, ~interior)):
                sel = pair[msel]
                if len(sel) == 0:
                    continue
                dflat = ((recv_pad3[sel, 0] * ps_r[1] + recv_pad3[sel, 1])
                         * ps_r[2] + recv_pad3[sel, 2])
                a = best_anchor[sel] + H   # padded frame
                sflat = []
                for ok_ in (0, 1):
                    for oj in (0, 1):
                        for oi in (0, 1):
                            f = (((a[:, 0] + oi) * ps_d[1] + a[:, 1] + oj)
                                 * ps_d[2] + a[:, 2] + ok_)
                            sflat.append(f)
                w = _tri_weights(best_uvw[sel])  # bit order i fastest
                groups.append(OversetGroup(
                    dst_block=bi, src_block=dbi,
                    dst_flat=dflat.astype(np.int32),
                    src_flat=np.stack(sflat).astype(np.int32),
                    weights=w, priority=prio))
    # orphan neighbor-average groups: applied LAST (priority 2) so they
    # read freshly interpolated fringe/compute values
    from collections import defaultdict
    by_block = defaultdict(list)
    for bi, dflat, srcs, wgt in orphan_groups:
        by_block[bi].append((dflat, srcs, wgt))
    for bi, items in by_block.items():
        dflats = np.array([d for d, _, _ in items], np.int32)
        sflats = np.stack([np.asarray(s, np.int32)
                           for _, s, _ in items], axis=1)   # (8, n)
        # group layout is (stencil, receiver) = (8, n) for BOTH arrays —
        # stacking weights along axis=0 gave (n, 8), which einsum "sn,snv"
        # silently accepted only when n happened to equal 8 (and then with
        # TRANSPOSED weights); caught by the auto-background overset test
        wgts = np.stack([w for _, _, w in items], axis=1)    # (8, n)
        groups.append(OversetGroup(
            dst_block=bi, src_block=bi, dst_flat=dflats,
            src_flat=sflats, weights=wgts, priority=2))
    groups.sort(key=lambda g: g.priority)
    return OversetTable(groups=tuple(groups), iblank=tuple(iblank),
                        n_orphans=n_orphans)


def device_table(table: Optional[OversetTable], dtype,
                 device) -> Optional[OversetTable]:
    """The table with every group's indices as int64 tensors and its weights
    as ``dtype`` tensors on ``device``, made once (``iblank`` stays numpy).
    Each group's receivers must be distinct: a scatter with a repeated
    index keeps an arbitrary one of its values on CUDA."""
    if table is None:
        return None
    groups = []
    for g in table.groups:
        dst = np.asarray(g.dst_flat)
        if len(np.unique(dst)) != len(dst):
            raise ValueError(
                f"overset group {g.dst_block}<-{g.src_block} (priority "
                f"{g.priority}) repeats a receiver")
        groups.append(dataclasses.replace(
            g,
            dst_flat=torch.as_tensor(dst, dtype=torch.int64, device=device),
            src_flat=torch.as_tensor(np.asarray(g.src_flat),
                                     dtype=torch.int64, device=device),
            weights=torch.as_tensor(np.asarray(g.weights), dtype=dtype,
                                    device=device)))
    return dataclasses.replace(table, groups=tuple(groups))


def apply_overset(w_list, table: Optional[OversetTable]):
    """Runtime fringe update: trilinear gather from donors, scatter into
    receivers (ghost AND interior fringe cells), group by group in the
    table's (priority) order, so interior-fringe receivers update first and
    then serve as fresh donors for outer-boundary ghosts. Out of place
    (``index_copy``), so ``torch.func.jvp``/``vjp`` pass through it.
    ``table`` is a ``device_table``."""
    if table is None or not table.groups:
        return w_list
    out = list(w_list)
    for g in table.groups:
        src = out[g.src_block]
        nv = src.shape[-1]
        wt = g.weights if g.weights.dtype == src.dtype else \
            g.weights.to(src.dtype)
        vals = torch.einsum("sn,snv->nv", wt,
                            src.reshape(-1, nv)[g.src_flat])
        dst = out[g.dst_block]
        flat = dst.reshape(-1, dst.shape[-1]).index_copy(
            0, g.dst_flat, vals.to(dst.dtype))
        out[g.dst_block] = flat.reshape(dst.shape)
    return out


def iblank_masks(table: Optional[OversetTable], nblocks: int,
                 dims: Sequence[Tuple[int, int, int]]):
    """Per-block (ni, nj, nk, 1) float masks: 1 for compute cells, 0 for
    fringe/hole — multiplied into the residual (the reference guards every
    kernel with iblank; here one mask at the end is equivalent because
    fringe/hole STATES are overwritten by interpolation each fill)."""
    if table is None:
        return [None] * nblocks
    return [(tab == IBLANK_COMPUTE).astype(np.float64)[..., None]
            for tab in table.iblank]


# ---------------------------------------------------------------------------
# Implicit hole cutting (reference: oversetAPI.F90 Steps 1-16 implicit path,
# overset/flagNearWall.F90 + floodInteriorCells.F90): no user callback —
# cells of one cluster that lie on the BODY side of another cluster's wall
# surface are holes, and enclosed non-hole pockets are flooded.
# ---------------------------------------------------------------------------

from adflow_torch.core.mesh import WALL_BCS as _WALL_BCS


def _wall_surface_of_cluster(mesh: MultiBlockMesh, clusters, cl: int):
    """(centers (n,3), into-body unit normals (n,3), diam (n,)) of all wall
    faces of cluster ``cl``."""
    cs, ns, ds = [], [], []
    for bi, blk in enumerate(mesh.blocks):
        if clusters[bi] != cl:
            continue
        dims = blk.dims
        for sf in blk.bcs:
            if sf.bc not in _WALL_BCS:
                continue
            ax = sf.face.axis
            t1, t2 = [a for a in range(3) if a != ax]
            rng = sf.rng or ((0, dims[t1]), (0, dims[t2]))
            sl = [None] * 3
            sl[ax] = dims[ax] if sf.face.is_high else 0
            sl[t1] = slice(rng[0][0], rng[0][1] + 1)
            sl[t2] = slice(rng[1][0], rng[1][1] + 1)
            xs = blk.x[tuple(sl)]
            c = 0.25 * (xs[:-1, :-1] + xs[1:, :-1] + xs[1:, 1:]
                        + xs[:-1, 1:])
            # quad area vector pointing +axis; +axis for t1<t2 ordering:
            # S = 0.5 (d1 x d2) with diagonals in (t1, t2) plane — sign
            # convention matches geom/metrics.face_areas for each axis
            d1 = xs[1:, 1:] - xs[:-1, :-1]
            d2 = xs[:-1, 1:] - xs[1:, :-1]
            s = 0.5 * np.cross(d1, d2)
            if (t1, t2) != ((ax + 1) % 3, (ax + 2) % 3):
                # ascending-order tangentials flip the cross orientation
                # for axis 1 (t1,t2)=(0,2) vs cyclic (2,0)
                if ax == 1:
                    s = -s
            sign = 1.0 if sf.face.is_high else -1.0
            s_body = sign * s            # out of fluid = into the body
            a = np.linalg.norm(s_body, axis=-1, keepdims=True)
            cs.append(c.reshape(-1, 3))
            ns.append((s_body / np.maximum(a, 1e-300)).reshape(-1, 3))
            ds.append(np.sqrt(np.maximum(a, 0.0)).reshape(-1))
    if not cs:
        return None
    return (np.concatenate(cs), np.concatenate(ns), np.concatenate(ds))


def implicit_hole_cut(mesh: MultiBlockMesh, clusters, centers):
    """Hole masks per block: containment behind other clusters' walls +
    flood of enclosed pockets. Requires (locally) closed wall surfaces —
    the standard body-in-background chimera setup."""
    try:
        from scipy import ndimage
    except ImportError:  # pragma: no cover
        ndimage = None
    nb = len(mesh.blocks)
    holes = [np.zeros(b.dims, bool) for b in mesh.blocks]
    surf = {}
    for cl in set(int(c) for c in clusters):
        surf[cl] = _wall_surface_of_cluster(mesh, clusters, cl)
    for bi in range(nb):
        for cl, s in surf.items():
            if s is None or clusters[bi] == cl:
                continue
            c, n, d = s
            tree = cKDTree(c)
            p = centers[bi].reshape(-1, 3)
            dist, idx = tree.query(p)
            side = np.einsum("ij,ij->i", p - c[idx], n[idx])
            # body side of the nearest wall face = inside. Cells slightly
            # OUTSIDE (within one facet diameter) blank too: the fringe
            # front then sits clear of the donor mesh's wall half-cell gap
            # (reference: flagNearWall.F90 + the nearWallDist option) —
            # without the margin, fringes land between the donor wall and
            # its first cell-center ring and orphan.
            inside = side > -d[idx]
            holes[bi] |= inside.reshape(mesh.blocks[bi].dims)
        # flood enclosed pockets (floodInteriorCells.F90): non-hole
        # components that never reach the block's outer boundary are
        # inside the body
        if ndimage is not None and holes[bi].any():
            lab, nlab = ndimage.label(~holes[bi])
            if nlab > 1:
                edge = np.zeros_like(holes[bi])
                edge[0], edge[-1] = True, True
                edge[:, 0], edge[:, -1] = True, True
                edge[:, :, 0], edge[:, :, -1] = True, True
                outside_labels = set(np.unique(lab[edge & (lab > 0)]))
                pocket = (lab > 0) & ~np.isin(lab, list(outside_labels))
                holes[bi] |= pocket
    return holes


def overlap_surface_weights(mesh: MultiBlockMesh, patches):
    """Zipper-equivalent overlap deduplication for surface integration
    (reference: overset/zipperMesh.F90:18 createZipperMesh +
    solver/zipperIntegrations.F90): where wall faces of two clusters cover
    the same physical surface, the coarser face gets weight 0 so integrals
    don't double-count. Gap triangulation is not performed — overlapping
    chimera surface setups should overlap by at least one face width.
    Returns one (T1, T2) weight array per patch (None if no overlap)."""
    clusters = _clusters(mesh)
    # collect all wall faces once
    allc, alla, allcl = [], [], []
    per_patch = []
    for p in patches:
        blk = mesh.blocks[p.block]
        xs = blk.x[p.fnode_sl]
        c = 0.25 * (xs[:-1, :-1] + xs[1:, :-1] + xs[1:, 1:] + xs[:-1, 1:])
        d1 = xs[1:, 1:] - xs[:-1, :-1]
        d2 = xs[:-1, 1:] - xs[1:, :-1]
        a = 0.5 * np.linalg.norm(np.cross(d1, d2), axis=-1)
        per_patch.append((c, a))
        allc.append(c.reshape(-1, 3))
        alla.append(a.reshape(-1))
        allcl.append(np.full(a.size, clusters[p.block]))
    if not allc or len(set(int(v) for v in np.concatenate(allcl))) < 2:
        return [None] * len(patches)
    allc = np.concatenate(allc)
    alla = np.concatenate(alla)
    allcl = np.concatenate(allcl)
    out = []
    for pi, p in enumerate(patches):
        c, a = per_patch[pi]
        mycl = clusters[p.block]
        other = allcl != mycl
        if not other.any():
            out.append(None)
            continue
        tree = cKDTree(allc[other])
        oa = alla[other]
        ocl = allcl[other]
        dist, idx = tree.query(c.reshape(-1, 3))
        diam = np.sqrt(np.maximum(a.reshape(-1), 0.0))
        odiam = np.sqrt(np.maximum(oa[idx], 0.0))
        close = dist < 0.75 * np.maximum(diam, odiam)
        # equal-area tie-break must be asymmetric (keep the LOWER cluster
        # id's face): a symmetric rule like `mycl > 0` zeroes BOTH patches
        # when two non-background clusters overlap with equal areas,
        # deleting that wall region from the force integral
        finer_other = (oa[idx] < a.reshape(-1)) | (
            np.isclose(oa[idx], a.reshape(-1)) & (mycl > ocl[idx]))
        w = np.where(close & finer_other, 0.0, 1.0)
        out.append(w.reshape(a.shape) if (w == 0).any() else None)
    return out


# ---------------------------------------------------------------------------
# Zipper gap triangulation
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ZipperGaps:
    """Triangles stitching the gap strips the overlap dedup leaves between
    overset surface patches (reference: overset/zipperMesh.F90:18
    createZipperMesh + stringOps.F90 — retained-region boundary "strings"
    from each cluster are pocket-triangulated so surface integrals are
    watertight; Chan 2009). Each triangle carries the (patch, face)
    association from which its pressure/traction data is taken at
    integration time (solver/zipperIntegrations.F90 concept)."""

    patch_idx: np.ndarray     # (nt,) index into the wall-patch list
    face_flat: np.ndarray     # (nt,) flat face index within that patch
    svec: np.ndarray          # (nt, 3) triangle area vectors (unoriented;
                              # integrate_forces aligns with the face normal)
    centroid: np.ndarray      # (nt, 3)

    @property
    def n_tris(self) -> int:
        return len(self.patch_idx)


def _retained_boundary_edges(xs: np.ndarray, keep: np.ndarray):
    """Edges adjacent to exactly one retained face of a patch.

    xs: (T1+1, T2+1, 3) patch nodes; keep: (T1, T2) bool. Returns
    (p0, p1, face_flat): edge endpoint coords + the retained face index.
    """
    T1, T2 = keep.shape
    k = keep.astype(np.int8)
    p0s, p1s, faces = [], [], []
    # edges along j (fixed i in 0..T1): between faces (i-1, j) and (i, j)
    lo = np.zeros((T1 + 1, T2), np.int8)
    hi = np.zeros((T1 + 1, T2), np.int8)
    lo[1:], hi[:-1] = k, k
    cnt = lo + hi
    ii, jj = np.nonzero(cnt == 1)
    if len(ii):
        p0s.append(xs[ii, jj]); p1s.append(xs[ii, jj + 1])
        fi = np.where(lo[ii, jj] == 1, np.clip(ii - 1, 0, T1 - 1), ii)
        faces.append(np.clip(fi, 0, T1 - 1) * T2 + jj)
    # edges along i (fixed j in 0..T2): between faces (i, j-1) and (i, j)
    lo = np.zeros((T1, T2 + 1), np.int8)
    hi = np.zeros((T1, T2 + 1), np.int8)
    lo[:, 1:], hi[:, :-1] = k, k
    cnt = lo + hi
    ii, jj = np.nonzero(cnt == 1)
    if len(ii):
        p0s.append(xs[ii, jj]); p1s.append(xs[ii + 1, jj])
        fj = np.where(lo[ii, jj] == 1, np.clip(jj - 1, 0, T2 - 1), jj)
        faces.append(ii * T2 + np.clip(fj, 0, T2 - 1))
    if not p0s:
        z = np.zeros((0, 3))
        return z, z, np.zeros(0, np.int64)
    return (np.concatenate(p0s), np.concatenate(p1s),
            np.concatenate(faces))


def _order_polylines(p0, p1):
    """Group undirected edges into ordered polylines (open chains first,
    then closed loops). Returns a list of (points (m, 3), closed)."""
    if not len(p0):
        return []
    pts = np.concatenate([p0, p1])
    scale = max(float(np.max(np.abs(pts))), 1.0)
    key = np.round(pts / (1e-9 * scale)).astype(np.int64)
    uniq, inv = np.unique(key, axis=0, return_inverse=True)
    coords = np.zeros((len(uniq), 3))
    coords[inv] = pts
    n0, n1 = inv[:len(p0)], inv[len(p0):]
    adj: dict = {}
    for e, (a, b) in enumerate(zip(n0, n1)):
        if a == b:
            continue
        adj.setdefault(a, []).append((b, e))
        adj.setdefault(b, []).append((a, e))
    used = np.zeros(len(p0), bool)
    out = []

    def walk(start):
        chain = [start]
        cur = start
        while True:
            nxt = None
            for (b, e) in adj.get(cur, []):
                if not used[e]:
                    used[e] = True
                    nxt = b
                    break
            if nxt is None:
                break
            chain.append(nxt)
            cur = nxt
        return chain

    deg1 = [nid for nid, lst in adj.items()
            if sum(1 for (_, e) in lst if not used[e]) == 1]
    for nid in deg1:
        if all(used[e] for (_, e) in adj[nid]):
            continue
        chain = walk(nid)
        if len(chain) >= 2:
            out.append((coords[chain], False))
    for nid in list(adj):
        if all(used[e] for (_, e) in adj[nid]):
            continue
        chain = walk(nid)
        if len(chain) >= 3:
            out.append((coords[chain], True))
    return out


def _stitch(A: np.ndarray, B: np.ndarray, closedA: bool, closedB: bool):
    """Greedy zipper triangulation between two polylines: at each step
    advance the side whose next point is closer to the other side's
    current point (the classic gap-strip march, zipperMesh.F90 concept).
    Returns (nt, 3, 3) triangle vertex array."""
    if closedA:
        A = np.concatenate([A, A[:1]])
    if closedB:
        B = np.concatenate([B, B[:1]])
    # align B's start and direction to A
    d0 = np.linalg.norm(B - A[0], axis=1)
    j0 = int(np.argmin(d0))
    B = np.concatenate([B[j0:], B[1:j0 + 1]]) if closedB else B
    if not closedB:
        if (np.linalg.norm(B[0] - A[0])
                > np.linalg.norm(B[-1] - A[0])):
            B = B[::-1]
    else:
        a_next = A[min(1, len(A) - 1)]
        if (np.linalg.norm(B[1] - a_next)
                > np.linalg.norm(B[-2] - a_next)):
            B = B[::-1]
    tris = []
    i = j = 0
    while i < len(A) - 1 or j < len(B) - 1:
        can_a = i < len(A) - 1
        can_b = j < len(B) - 1
        if can_a and can_b:
            da = np.linalg.norm(A[i + 1] - B[j])
            db = np.linalg.norm(B[j + 1] - A[i])
            adv_a = da <= db
        else:
            adv_a = can_a
        if adv_a:
            tris.append((A[i], A[i + 1], B[j]))
            i += 1
        else:
            tris.append((A[i], B[j + 1], B[j]))
            j += 1
    return np.asarray(tris).reshape(-1, 3, 3)


def build_zipper_gaps(mesh: MultiBlockMesh, patches,
                      weights) -> Optional[ZipperGaps]:
    """Triangulate the gap strips between overset surface patches after
    overlap dedup (``overlap_surface_weights``). Returns None when no
    cross-cluster surface overlap exists."""
    if cKDTree is None or weights is None:
        return None
    clusters = _clusters(mesh)
    pdata = []           # per patch: xs, keep, centers, diam
    any_removed = False
    for pi, p in enumerate(patches):
        blk = mesh.blocks[p.block]
        xs = np.asarray(blk.x[p.fnode_sl], float)
        T1, T2 = xs.shape[0] - 1, xs.shape[1] - 1
        w = weights[pi]
        keep = np.ones((T1, T2), bool) if w is None else (
            np.asarray(w) > 0.5)
        any_removed |= (~keep).any()
        c = 0.25 * (xs[:-1, :-1] + xs[1:, :-1] + xs[1:, 1:] + xs[:-1, 1:])
        d1 = xs[1:, 1:] - xs[:-1, :-1]
        d2 = xs[:-1, 1:] - xs[1:, :-1]
        a = 0.5 * np.linalg.norm(np.cross(d1, d2), axis=-1)
        pdata.append((xs, keep, c, np.sqrt(np.maximum(a, 0.0)),
                      clusters[p.block]))
    if not any_removed:
        return None

    cls = sorted(set(int(d[4]) for d in pdata))
    # retained-face trees per cluster (for the closeness filter and the
    # triangle -> data-face association)
    cl_pts, cl_meta = {}, {}
    for cl in cls:
        pts, meta = [], []
        for pi, (xs, keep, c, dm, pcl) in enumerate(pdata):
            if pcl != cl:
                continue
            idx = np.argwhere(keep)
            if len(idx):
                pts.append(c[idx[:, 0], idx[:, 1]])
                meta.append(np.stack(
                    [np.full(len(idx), pi),
                     idx[:, 0] * keep.shape[1] + idx[:, 1]], axis=1))
        if pts:
            cl_pts[cl] = np.concatenate(pts)
            cl_meta[cl] = np.concatenate(meta)
    trees = {cl: cKDTree(cl_pts[cl]) for cl in cl_pts}

    # gap-front edges per cluster: retained-region boundary edges whose
    # midpoint lies on/near ANOTHER cluster's retained surface
    front = {cl: ([], []) for cl in cls}       # (p0 list, p1 list)
    for pi, (xs, keep, c, dm, pcl) in enumerate(pdata):
        p0, p1, faces = _retained_boundary_edges(xs, keep)
        if not len(p0):
            continue
        mid = 0.5 * (p0 + p1)
        elen = np.linalg.norm(p1 - p0, axis=1)
        close = np.zeros(len(p0), bool)
        for cl in cls:
            if cl == pcl or cl not in trees:
                continue
            dist, _ = trees[cl].query(mid)
            close |= dist < 1.5 * np.maximum(elen, 1e-300)
        if close.any():
            front[pcl][0].append(p0[close])
            front[pcl][1].append(p1[close])

    live = [cl for cl in cls if front[cl][0]]
    if len(live) < 2:
        return None
    # polylines per cluster
    lines = {cl: _order_polylines(np.concatenate(front[cl][0]),
                                  np.concatenate(front[cl][1]))
             for cl in live}
    # pair each polyline of the FIRST live cluster with the nearest
    # polyline of each other cluster and stitch
    tris = []
    clA = live[0]
    for A, closedA in lines[clA]:
        for clB in live[1:]:
            if not lines[clB]:
                continue
            best, bd = None, np.inf
            for B, closedB in lines[clB]:
                tb = cKDTree(B)
                d = float(np.mean(tb.query(A)[0]))
                if d < bd:
                    bd, best = d, (B, closedB)
            B, closedB = best
            t = _stitch(A, B, closedA, closedB)
            if len(t):
                tris.append(t)
    if not tris:
        return None
    tv = np.concatenate(tris)
    svec = 0.5 * np.cross(tv[:, 1] - tv[:, 0], tv[:, 2] - tv[:, 0])
    cen = tv.mean(axis=1)
    # drop degenerate slivers
    area = np.linalg.norm(svec, axis=1)
    ref_a = np.median([float(np.median(d[3]) ** 2) for d in pdata])
    good = area > 1e-8 * max(ref_a, 1e-300)
    svec, cen = svec[good], cen[good]
    if not len(svec):
        return None
    # associate each triangle with the nearest retained face (data source)
    allpts = np.concatenate([cl_pts[cl] for cl in cl_pts])
    allmeta = np.concatenate([cl_meta[cl] for cl in cl_pts])
    tree = cKDTree(allpts)
    _, nearest = tree.query(cen)
    return ZipperGaps(patch_idx=allmeta[nearest, 0],
                      face_flat=allmeta[nearest, 1],
                      svec=svec, centroid=cen)
