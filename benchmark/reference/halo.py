# Frozen copy of adflow_torch/dist/halo.py for the benchmark's reference, its
# imports made local.
"""Block-to-block halo exchange (counterpart of adflow_tpu/dist/halo.py).

Two forms of the same exchange:

- the per-block-list path: a 1-to-1 connection maps a contiguous ghost box
  onto a contiguous donor box, so the exchange is slicing + axis
  permutation + flips (``build_conn_ops``, ``exchange_halos_list``);
- the stacked path (dist/stacked.py): every block padded to one bucket
  shape and stacked on a leading axis, each ghost cell of each connection
  knows its donor (slot, flat cell), and the exchange is one gather and one
  out-of-place scatter (``HaloTable``, ``build_halo_table``,
  ``exchange_halos``). Across ranks the same table drives
  dist/comm.py's ``HaloExchange``.

Ghost regions are enumerated over the tangentially *extended* face window,
and the fill sequence BC -> exchange -> BC (physics/residual.py fill_halos)
resolves the corners. The O-mesh i-wrap of ``wing_omesh`` is a
self-connection of this kind.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from .mesh import MultiBlockMesh

H = 2


@dataclasses.dataclass(frozen=True)
class HaloTable:
    """Gather table for all b2b ghost cells of all blocks.

    dst_block[n], dst_flat[n]: ghost cell location (flat index into the
        halo-padded (NI+4)*(NJ+4)*(NK+4) cell space of its block)
    src_block[n], src_flat[n]: donor cell in the donor block's padded space
    rot[n]: index into ``rotations`` (0 = identity) applied to the momentum
        vector for periodic connections.

    Each ghost cell is listed once (``build_halo_table``).
    """

    dst_block: np.ndarray
    dst_flat: np.ndarray
    src_block: np.ndarray
    src_flat: np.ndarray
    rot: np.ndarray
    rotations: np.ndarray  # (n_rot, 3, 3), rotations[0] = I
    padded_shape: Tuple[int, int, int]


def _lateral_window(rng_ax, dim, ext):
    """Tangential cell range for one lateral axis: the connection's rng
    window (full face if None), extended by ``ext`` only where the window
    touches the physical block end."""
    lo, hi = (0, dim) if rng_ax is None else rng_ax
    return (lo - (ext if lo == 0 else 0), hi + (ext if hi == dim else 0))


def _ghost_cells_for_face(face, dims, ext: int = H, rng=None):
    """Cell coords (interior frame, may be negative) of the 2-deep ghost
    region behind ``face`` (restricted to the partial-face window ``rng``
    when given), extended ``ext`` cells tangentially."""
    ax = face.axis
    n = dims[ax]
    t_axes = [a for a in range(3) if a != ax]
    rngs = []
    for a in range(3):
        if a == ax:
            rngs.append(np.arange(n, n + H) if face.is_high
                        else np.arange(-H, 0))
        else:
            r = None if rng is None else rng[t_axes.index(a)]
            lo, hi = _lateral_window(r, dims[a], ext)
            rngs.append(np.arange(lo, hi))
    g = np.stack(np.meshgrid(*rngs, indexing="ij"), axis=-1)
    return g.reshape(-1, 3)


def _last_of_each(key: np.ndarray) -> np.ndarray:
    """Ascending indices of the last occurrence of each value of ``key``."""
    rev = key[::-1]
    _, first_in_rev = np.unique(rev, return_index=True)
    return np.sort(len(key) - 1 - first_in_rev)


def build_halo_table(mesh: MultiBlockMesh,
                     padded_shape: Optional[Tuple[int, int, int]] = None
                     ) -> Optional[HaloTable]:
    """Precompute the exchange gather table (all blocks padded to a common
    halo-padded shape so flat indices are uniform).

    Where two connections list the same ghost cell (the extended corner
    windows of a block split along two axes do), only the last entry is
    kept: the JAX package's scatter on the CPU writes its entries in order,
    so the last one wins there, while a scatter with repeated indices on a
    card, or across ranks, has no order. The table that comes out lists
    every ghost cell once."""
    if padded_shape is None:
        padded_shape = tuple(
            max(b.dims[a] for b in mesh.blocks) + 2 * H for a in range(3))
    dstb, dstf, srcb, srcf, rots = [], [], [], [], []
    rotations = [np.eye(3)]

    def flat(idx3, shape):
        return ((idx3[:, 0] * shape[1]) + idx3[:, 1]) * shape[2] + idx3[:, 2]

    for bi, blk in enumerate(mesh.blocks):
        for conn in blk.conns:
            donor = mesh.blocks[conn.donor_block]
            ghosts = _ghost_cells_for_face(conn.face, blk.dims,
                                           rng=conn.rng)
            # affine map into donor cell coords:
            # donor[|t|-1] = sign(t) * mine[m] + offset[m]
            d = np.zeros_like(ghosts)
            for m in range(3):
                t = conn.transform[m]
                d[:, abs(t) - 1] = np.sign(t) * ghosts[:, m] + conn.offset[m]
            # clamp donors into the donor's valid halo-padded range; cells
            # mapping outside (far corners of non-matching topology) read
            # the nearest valid cell
            dpad = np.clip(d + H, 0, np.array(donor.dims) + 2 * H - 1)
            gpad = ghosts + H
            dstb.append(np.full(len(ghosts), bi, np.int32))
            dstf.append(flat(gpad, padded_shape).astype(np.int32))
            srcb.append(np.full(len(ghosts), conn.donor_block, np.int32))
            srcf.append(flat(dpad, padded_shape).astype(np.int32))
            if conn.rotation is not None:
                rotations.append(np.asarray(conn.rotation))
                rid = len(rotations) - 1
            else:
                rid = 0
            rots.append(np.full(len(ghosts), rid, np.int32))

    if not dstb:
        return None
    dstb, dstf = np.concatenate(dstb), np.concatenate(dstf)
    n_pad = int(np.prod(padded_shape))
    keep = _last_of_each(dstb.astype(np.int64) * n_pad + dstf)
    return HaloTable(
        dst_block=dstb[keep], dst_flat=dstf[keep],
        src_block=np.concatenate(srcb)[keep],
        src_flat=np.concatenate(srcf)[keep],
        rot=np.concatenate(rots)[keep], rotations=np.stack(rotations),
        padded_shape=padded_shape)


def rotate_momentum(src, rot, rotations):
    """Rows (n, nv) with the momentum (channels 1-3) of row n turned by
    ``rotations[rot[n]]``, where the table has a rotation and the rows a
    momentum; else ``src``. ``rot`` an index tensor, ``rotations`` (n_rot,
    3, 3) numpy."""
    if len(rotations) == 1 or src.shape[-1] < 4:
        return src
    rotm = torch.as_tensor(rotations, dtype=src.dtype,
                           device=src.device)[rot]
    mom = torch.einsum("nab,nb->na", rotm, src[:, 1:4])
    return torch.cat([src[:, :1], mom, src[:, 4:]], dim=-1)


def exchange_halos(w_stack, table: Optional[HaloTable]):
    """Fill b2b ghost cells of the whole stack on one device. w_stack:
    (nblocks, NI+4, NJ+4, NK+4, nv) with every block padded to the common
    shape. One gather and one out-of-place scatter with the table's
    indices, so ``torch.func.jvp``/``vjp`` pass through it; nv is arbitrary
    (state, tangents, coordinates...)."""
    if table is None:
        return w_stack
    nb, nv = w_stack.shape[0], w_stack.shape[-1]
    n_pad = int(np.prod(table.padded_shape))
    dev = w_stack.device
    src_idx = torch.as_tensor(
        table.src_block.astype(np.int64) * n_pad + table.src_flat,
        device=dev)
    dst_idx = torch.as_tensor(
        table.dst_block.astype(np.int64) * n_pad + table.dst_flat,
        device=dev)
    flat = w_stack.reshape(nb * n_pad, nv)
    src = rotate_momentum(flat[src_idx],
                          torch.as_tensor(table.rot, device=dev),
                          table.rotations)
    return flat.index_copy(0, dst_idx, src).reshape(w_stack.shape)


@dataclasses.dataclass(frozen=True)
class ConnOp:
    dst_block: int
    src_block: int
    dst_sl: Tuple[slice, slice, slice]
    src_sl: Tuple[slice, slice, slice]
    perm: Tuple[int, int, int]        # output axis m <- donor axis perm[m]
    rotation: Optional[np.ndarray] = None


def build_conn_ops(mesh: MultiBlockMesh, ext: int = H) -> List[ConnOp]:
    ops: List[ConnOp] = []
    for bi, blk in enumerate(mesh.blocks):
        dims = blk.dims
        for conn in blk.conns:
            donor = mesh.blocks[conn.donor_block]
            ax = conn.face.axis
            t_axes = [a for a in range(3) if a != ax]
            lo = [0, 0, 0]
            hi = [0, 0, 0]
            for a in range(3):
                if a == ax:
                    if conn.face.is_high:
                        lo[a], hi[a] = dims[a], dims[a] + H
                    else:
                        lo[a], hi[a] = -H, 0
                else:
                    r = (None if conn.rng is None
                         else conn.rng[t_axes.index(a)])
                    lo[a], hi[a] = _lateral_window(r, dims[a], ext)
            dst_sl = tuple(slice(l + H, h + H) for l, h in zip(lo, hi))
            src_sl = [None, None, None]
            perm = [0, 0, 0]
            for m in range(3):
                t = conn.transform[m]
                q = abs(t) - 1
                perm[m] = q
                if t > 0:
                    dlo = lo[m] + conn.offset[m]
                    dhi = hi[m] + conn.offset[m]
                    src_sl[q] = slice(dlo + H, dhi + H)
                else:
                    # descending donor coords as mine ascend
                    dhi_incl = -lo[m] + conn.offset[m]
                    dlo_incl = -(hi[m] - 1) + conn.offset[m]
                    stop = dlo_incl + H - 1
                    src_sl[q] = slice(dhi_incl + H, None if stop < 0 else stop,
                                      -1)
                dd = donor.dims[q]
                s = src_sl[q]
                if s.step in (None, 1):
                    assert 0 <= s.start and s.stop <= dd + 2 * H, (bi, conn)
                else:
                    assert s.start <= dd + 2 * H - 1, (bi, conn)
            ops.append(ConnOp(
                dst_block=bi, src_block=conn.donor_block, dst_sl=dst_sl,
                src_sl=tuple(src_sl), perm=tuple(perm),
                rotation=(None if conn.rotation is None
                          else np.asarray(conn.rotation))))
    return ops


def _read_box(w, src_sl):
    """w[src_sl] where a slice may have step -1 (torch slices cannot):
    read the ascending box, then flip those axes."""
    fwd, flips = [], []
    for ax, s in enumerate(src_sl):
        if s.step in (None, 1):
            fwd.append(s)
        else:
            lo = 0 if s.stop is None else s.stop + 1
            fwd.append(slice(lo, s.start + 1))
            flips.append(ax)
    box = w[tuple(fwd)]
    return torch.flip(box, flips) if flips else box


def exchange_halos_list(w_list: List[torch.Tensor], ops: Sequence[ConnOp]
                        ) -> List[torch.Tensor]:
    """Exchange b2b halos for per-block tensors (list of (ni+4, nj+4, nk+4,
    nv)). Reads all sources before any write; returns new tensors for the
    blocks it writes."""
    patches = []
    for op in ops:
        src = _read_box(w_list[op.src_block], op.src_sl)
        src = src.permute(*op.perm, 3)
        if op.rotation is not None and src.shape[-1] >= 4:
            rotm = torch.as_tensor(op.rotation, dtype=src.dtype,
                                   device=src.device)
            mom = torch.einsum("ab,ijkb->ijka", rotm, src[..., 1:4])
            src = torch.cat([src[..., :1], mom, src[..., 4:]], dim=-1)
        patches.append(src)
    out = list(w_list)
    for bi in {op.dst_block for op in ops}:
        out[bi] = out[bi].clone()
    for op, patch in zip(ops, patches):
        out[op.dst_block][op.dst_sl] = patch
    return out
