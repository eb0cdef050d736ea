"""Collectives over a ``torch.distributed`` process group: what GSPMD and
``shard_map`` insert for the JAX package (the reference's MPI halo
exchange and ``mpi_allreduce`` of norms, haloExchange.F90 whalo2 and
solvers.F90 convergenceInfo).

One process per device. Every function takes ``group``: a
``torch.distributed.ProcessGroup``, or None for one device with no
collective. A group of one rank runs the reductions all the same, so a
single-card run of the stacked path drives NCCL; its exchange has no
peer and stays on the device as plain tensor ops.

- ``HaloPlan`` / ``halo_plan``: one rank's share of a stacked
  ``HaloTable`` (dist/halo.py). Rank r holds the equal-count slice of slots
  ``[r*per, (r+1)*per)`` that ``balance_blocks`` orders the stack for. From
  the global table each rank builds, on the host and once, the entries it
  takes from its own slots and, per peer, the rows it sends and the ghost
  cells it receives, with index tensors on its device.
- ``HaloExchange``: the exchange as an ``autograd.Function``. Its forward
  is one ``all_to_all_single`` with the split sizes, the periodic rotation
  applied on the receiver; its ``jvp`` is the same exchange of the tangent
  (the map is linear) and its ``backward`` the transpose: ghost
  cotangents go back to their donors and are added there, and the
  overwritten ghosts get zero. Neither ``torch.func`` nor autograd
  differentiates through c10d collectives; this wrapper is what lets ANK's
  jvp matvec and the adjoint's vjp cross ranks.
- ``KRing``: the k-split's neighbour exchange of 2-deep slabs, one
  ``batch_isend_irecv`` with every rank posting its operations (NCCL
  deadlocks on unbatched, unmatched point-to-point calls); its backward is
  the reversed ring, adding into the interior slabs.
- ``all_sum``, ``all_max``, ``global_norm``, ``gather_stack``: the
  reductions and the gather of every rank's slots.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from adflow_torch.dist.halo import HaloTable, rotate_momentum
from adflow_torch.utils import trace


def world(group) -> Tuple[int, int]:
    """(rank, size) of this process in ``group``; (0, 1) for None."""
    if group is None:
        return 0, 1
    return dist.get_rank(group), dist.get_world_size(group)


def all_sum(t: torch.Tensor, group) -> torch.Tensor:
    """Sum of ``t`` over the ranks (a new tensor; ``t`` for None)."""
    if group is None:
        return t
    t = t.clone()
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    return t


def all_max(t: torch.Tensor, group) -> torch.Tensor:
    if group is None:
        return t
    t = t.clone()
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group)
    return t


def global_norm(v: torch.Tensor, group) -> torch.Tensor:
    """2-norm of the vector whose rank-local pieces are ``v``."""
    if group is None:
        return torch.linalg.norm(v)
    return torch.sqrt(all_sum(torch.sum(v * v), group))


def agreed(flag: bool, group) -> bool:
    """True on every rank when ``flag`` is true on any: a stop that one
    rank decides alone would leave the others waiting in their next
    collective."""
    if group is None:
        return bool(flag)
    dev = "cuda" if dist.get_backend(group) == "nccl" else "cpu"
    t = torch.tensor([1.0 if flag else 0.0], device=dev)
    trace.host_sync()
    return bool(all_max(t, group).item() > 0.0)


def gather_stack(w_local: torch.Tensor, group) -> torch.Tensor:
    """The whole stack (every rank's slots in rank order) on every rank."""
    if group is None:
        return w_local
    parts = [torch.empty_like(w_local) for _ in range(world(group)[1])]
    dist.all_gather(parts, w_local.contiguous(), group=group)
    return torch.cat(parts)


# ---------------------------------------------------------------------------
# the stacked halo exchange
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class HaloPlan:
    """One rank's share of a ``HaloTable``; indices are rows of the rank's
    flat (per * n_pad, nv) stack.

    local_src: donors of the entries whose donor and ghost are both on this
        rank, the first ``len(local_src)`` of ``dst_all``;
    send_idx, send_counts: rows sent to each peer, in peer order;
    recv_counts: the ghost rows received from each peer, in the order the
        peer sends them, the rest of ``dst_all``;
    dst_all, rot_all: the ghost rows the forward scatters, and their
        rotations.
    """

    group: object
    rotations: np.ndarray
    local_src: torch.Tensor
    send_idx: torch.Tensor
    send_counts: List[int]
    recv_counts: List[int]
    dst_all: torch.Tensor
    rot_all: torch.Tensor

    @property
    def remote(self) -> bool:
        return self.group is not None and world(self.group)[1] > 1


def halo_plan(table: HaloTable, nb: int, group, device) -> HaloPlan:
    """Build this rank's ``HaloPlan`` from the global table of an
    ``nb``-slot stack (host work, once). ``nb`` must be a multiple of the
    group's size."""
    rank, size = world(group)
    per = nb // size
    n_pad = int(np.prod(table.padded_shape))
    src_rank = table.src_block // per
    dst_rank = table.dst_block // per
    src_row = (table.src_block % per).astype(np.int64) * n_pad + table.src_flat
    dst_row = (table.dst_block % per).astype(np.int64) * n_pad + table.dst_flat
    mine = (src_rank == rank) & (dst_rank == rank)
    send_idx, send_counts, recv_dst, recv_rot, recv_counts = [], [], [], [], []
    for q in range(size):
        out_q = (src_rank == rank) & (dst_rank == q) & (q != rank)
        in_q = (src_rank == q) & (dst_rank == rank) & (q != rank)
        send_idx.append(src_row[out_q])
        send_counts.append(int(out_q.sum()))
        recv_dst.append(dst_row[in_q])
        recv_rot.append(table.rot[in_q])
        recv_counts.append(int(in_q.sum()))

    def t(a):
        return torch.as_tensor(np.asarray(a, np.int64), device=device)

    return HaloPlan(
        group=group, rotations=table.rotations, local_src=t(src_row[mine]),
        send_idx=t(np.concatenate(send_idx)), send_counts=send_counts,
        recv_counts=recv_counts,
        dst_all=t(np.concatenate([dst_row[mine]] + recv_dst)),
        rot_all=t(np.concatenate([table.rot[mine]] + recv_rot)))


def _all_to_all(send: torch.Tensor, send_counts, recv_counts, group):
    recv = send.new_empty((sum(recv_counts),) + tuple(send.shape[1:]))
    dist.all_to_all_single(recv, send.contiguous(),
                           output_split_sizes=list(recv_counts),
                           input_split_sizes=list(send_counts), group=group)
    return recv


def _exchange_rows(flat: torch.Tensor, plan: HaloPlan) -> torch.Tensor:
    """The forward on a flat (rows, nv) stack: every donor row read before
    any ghost is written, remote rows through one all_to_all."""
    src = flat[plan.local_src]
    if plan.remote:
        recv = _all_to_all(flat[plan.send_idx], plan.send_counts,
                           plan.recv_counts, plan.group)
        src = torch.cat([src, recv])
    src = rotate_momentum(src, plan.rot_all, plan.rotations)
    return flat.index_copy(0, plan.dst_all, src)


def _exchange_rows_transposed(flat_g: torch.Tensor, plan: HaloPlan
                              ) -> torch.Tensor:
    """The transpose: ghost cotangents (rotated back) added into their
    donors, here or on the rank that sent them; ghosts zeroed."""
    g = flat_g[plan.dst_all]
    if len(plan.rotations) > 1 and g.shape[-1] >= 4:
        rot_t = np.ascontiguousarray(np.transpose(plan.rotations, (0, 2, 1)))
        g = rotate_momentum(g, plan.rot_all, rot_t)
    out = flat_g.index_fill(0, plan.dst_all, 0.0)
    n_local = plan.local_src.shape[0]
    out = out.index_add(0, plan.local_src, g[:n_local])
    if plan.remote:
        back = _all_to_all(g[n_local:], plan.recv_counts, plan.send_counts,
                           plan.group)
        out = out.index_add(0, plan.send_idx, back)
    return out


class HaloExchange(torch.autograd.Function):
    """``apply(w_local, plan)``: the stacked exchange across ranks, with
    its jvp (the same exchange) and its transpose as backward."""

    @staticmethod
    def forward(w, plan):
        nv = w.shape[-1]
        return _exchange_rows(w.reshape(-1, nv), plan).reshape(w.shape)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.plan = inputs[1]

    @staticmethod
    def jvp(ctx, w_t, _plan_t):
        nv = w_t.shape[-1]
        return _exchange_rows(w_t.reshape(-1, nv), ctx.plan).reshape(
            w_t.shape)

    @staticmethod
    def backward(ctx, g):
        nv = g.shape[-1]
        return (_exchange_rows_transposed(g.reshape(-1, nv), ctx.plan)
                .reshape(g.shape), None)


def exchange(w_local: torch.Tensor, plan: Optional[HaloPlan]):
    """Fill the b2b ghost cells of this rank's slots (per, NI+4, NJ+4,
    NK+4, nv). Without remote peers the exchange is plain tensor ops, which
    ``torch.func`` differentiates itself."""
    if plan is None:
        return w_local
    if not plan.remote:
        return HaloExchange.forward(w_local, plan)
    return HaloExchange.apply(w_local, plan)


# ---------------------------------------------------------------------------
# the k-split ring
# ---------------------------------------------------------------------------

def _ring(lo_send, hi_send, group):
    """Send ``lo_send`` to rank-1 and ``hi_send`` to rank+1 (where they
    exist) in one batch; returns (from rank-1, from rank+1), None where
    there is no neighbour."""
    rank, size = world(group)
    ops, from_lo, from_hi = [], None, None
    if rank > 0:
        from_lo = torch.empty_like(hi_send)
        ops += [dist.P2POp(dist.isend, lo_send.contiguous(),
                           dist.get_global_rank(group, rank - 1), group),
                dist.P2POp(dist.irecv, from_lo,
                           dist.get_global_rank(group, rank - 1), group)]
    if rank < size - 1:
        from_hi = torch.empty_like(lo_send)
        ops += [dist.P2POp(dist.isend, hi_send.contiguous(),
                           dist.get_global_rank(group, rank + 1), group),
                dist.P2POp(dist.irecv, from_hi,
                           dist.get_global_rank(group, rank + 1), group)]
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return from_lo, from_hi


def _k_ring(w, group):
    """k-halos [0:2] from rank-1's top interior slab, [-2:] from rank+1's
    bottom one; out of place."""
    from_lo, from_hi = _ring(w[:, :, 2:4], w[:, :, -4:-2], group)
    parts = [w[:, :, 0:2] if from_lo is None else from_lo, w[:, :, 2:-2],
             w[:, :, -2:] if from_hi is None else from_hi]
    return torch.cat(parts, dim=2)


def _k_ring_transposed(g, group):
    """The reversed ring: each overwritten halo's cotangent goes back to
    the neighbour's interior slab it came from and is added there (the two
    slabs are one when a rank holds two k-planes)."""
    rank, size = world(group)
    nk = g.shape[2]
    lo_halo, hi_halo = g[:, :, 0:2], g[:, :, -2:]
    from_lo, from_hi = _ring(lo_halo, hi_halo, group)
    zero = torch.zeros_like(lo_halo)
    out = torch.cat([lo_halo if rank == 0 else zero, g[:, :, 2:-2],
                     hi_halo if rank == size - 1 else zero], dim=2)
    if from_lo is not None:
        out = out.index_add(2, torch.arange(2, 4, device=g.device), from_lo)
    if from_hi is not None:
        out = out.index_add(2, torch.arange(nk - 4, nk - 2, device=g.device),
                            from_hi)
    return out


class KRing(torch.autograd.Function):
    """``apply(w, group)``: the k-split neighbour exchange of one rank's
    padded block (ni+4, nj+4, nkl+4, nv), with its jvp and transpose."""

    @staticmethod
    def forward(w, group):
        return _k_ring(w, group)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.group = inputs[1]

    @staticmethod
    def jvp(ctx, w_t, _group_t):
        return _k_ring(w_t, ctx.group)

    @staticmethod
    def backward(ctx, g):
        return _k_ring_transposed(g, ctx.group), None
