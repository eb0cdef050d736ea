"""Block-to-block halo exchange (counterpart of the per-block-list path of
adflow_tpu/dist/halo.py).

A 1-to-1 connection maps a contiguous ghost box onto a contiguous donor box,
so the exchange is slicing + axis permutation + flips. Ghost regions are
enumerated over the tangentially *extended* face window, and the fill
sequence BC -> exchange -> BC (physics/residual.py fill_halos) resolves the
corners. The O-mesh i-wrap of ``wing_omesh`` is a self-connection of this
kind.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from adflow_torch.core.mesh import MultiBlockMesh

H = 2


def _lateral_window(rng_ax, dim, ext):
    """Tangential cell range for one lateral axis: the connection's rng
    window (full face if None), extended by ``ext`` only where the window
    touches the physical block end."""
    lo, hi = (0, dim) if rng_ax is None else rng_ax
    return (lo - (ext if lo == 0 else 0), hi + (ext if hi == dim else 0))


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
