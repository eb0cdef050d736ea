"""Blocks over devices: the stacked multi-block layout (counterpart of
adflow_tpu/dist/stacked.py; reference: ADflow's load balancing and halo
exchange, loadBalance.F90:5 loadBalanceGrid, :677
splitBlockInitialization, :880 splitBlocksLoadBalance, haloExchange.F90:109
whalo2).

Blocks are split until they distribute evenly (``split_block``,
``balance_blocks``, host numpy, copied from the JAX package), padded to one
bucket shape and stacked on a leading slot axis. The JAX package shards
that axis over a device mesh and lets GSPMD insert the collectives; here
one process per device holds its equal-count slice of the slots, rank r
the slots ``[r*per, (r+1)*per)``, and dist/comm.py makes the collectives
explicit: the b2b exchange is dist/halo.py's gather table split into what
each rank takes from its own slots and what it sends and receives
(``HaloExchange``), and every norm and dot product is completed by an
``all_reduce``. Every function reads the process group from the
``StackedProblem``; ``group=None`` is one device with every slot and no
collective.

The residual is a loop over the rank's slots: each calls
``block_residual`` with its porosities, so on CUDA f32 K1 (RANS-SA) or
K2 (Euler, laminar) launches once per real slot and evaluation; a dummy
slot (padding to equal counts) gives zeros without a launch. Pad cells and
dummy slots are masked with ``torch.where``, never by multiplying: the pad
can produce non-finite values whose tangents would survive a mask
multiply.

Block splitting (``split_block``) is general: any block of an arbitrary
multiblock mesh can be cut, with every connection whose donor was the cut
block remapped onto the parts; straddling windows become partial-face
(``rng``) connections. A cut may not pass through the 2-deep ghost window
of a connected face normal to the cut (``balance_blocks`` keeps cuts >= 2
cells from faces).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from adflow_torch.core.mesh import (
    B2BConnection, BCSubface, Block, Face, MultiBlockMesh)
from adflow_torch.core.refstate import ReferenceState
from adflow_torch.dist import comm
from adflow_torch.dist.halo import HaloTable, build_halo_table
from adflow_torch.geom.metrics import BlockMetrics, compute_metrics_conn
from adflow_torch.physics.bc import apply_bcs, build_bc_ops
from adflow_torch.physics.residual import (
    ProblemConfig, _build_porosities, block_residual)
from adflow_torch.physics.thermo import IRHO, IRHOE, pressure
from adflow_torch.physics.timestep import local_timestep
from adflow_torch.solvers.smoothers import RK_COEFFS

H = 2


# ---------------------------------------------------------------------------
# block splitting (loadBalance.F90:677 splitBlockInitialization analogue)
# ---------------------------------------------------------------------------

def _clip_rng(rng, lo, hi):
    """Intersect a half-open range with [lo, hi); None if empty."""
    a0, a1 = max(rng[0], lo), min(rng[1], hi)
    return (a0 - lo, a1 - lo) if a1 > a0 else None


_OLD_DONOR = -12345   # phase-A sentinel: "donor is the pre-split block"


def _remap_donor_conn(c: B2BConnection, rec_dims, bi: int, new_index: int,
                      axis: int, cut: int, n_axis: int
                      ) -> List[B2BConnection]:
    """Split/retarget one connection whose donor was the pre-split block.

    Reference analogue: donor-side remapping of 1-to-1 subfaces when a
    block is split for load balance (loadBalance.F90:880
    splitBlocksLoadBalance). The receiver's ghost window maps affinely to
    donor coords (donor[|t|-1] = sign(t)*mine + offset); the receiver axis
    m* with |transform[m*]|-1 == axis controls the donor's split-axis
    coordinate, so partitioning the m* range at the cut yields at most two
    partial-face connections, each retargeted to one part (part-1 donors
    renumbered by -cut through offset[m*]).
    """
    ax = c.face.axis
    t_axes = [a for a in range(3) if a != ax]
    rng = c.rng or ((0, rec_dims[t_axes[0]]), (0, rec_dims[t_axes[1]]))
    ranges = {ax: ((rec_dims[ax], rec_dims[ax] + 2) if c.face.is_high
                   else (-2, 0)),
              t_axes[0]: tuple(rng[0]), t_axes[1]: tuple(rng[1])}
    mstar = next(m for m in range(3) if abs(c.transform[m]) - 1 == axis)
    s = 1 if c.transform[mstar] > 0 else -1
    mlo, mhi = ranges[mstar]
    d_ends = (s * mlo + c.offset[mstar], s * (mhi - 1) + c.offset[mstar])
    dlo, dhi = min(d_ends), max(d_ends) + 1

    out: List[B2BConnection] = []
    for plo, phi, donor_idx, dshift in ((0, cut, bi, 0),
                                        (cut, n_axis, new_index, -cut)):
        # the depth direction may legitimately reach past the donor's ends
        # (2nd ghost layer beyond a donor of depth < 2 never happens for
        # cut in [2, n-2]); clamp the partition windows to the donor range
        a0, a1 = max(dlo, plo), min(dhi, phi)
        if a0 >= a1:
            continue
        if s > 0:
            m0, m1 = a0 - c.offset[mstar], a1 - c.offset[mstar]
        else:
            m0, m1 = (c.offset[mstar] - a1 + 1, c.offset[mstar] - a0 + 1)
        off = list(c.offset)
        off[mstar] = off[mstar] + dshift
        if mstar == ax:
            # the ghost DEPTH maps onto the split axis: the 2-deep window
            # must land entirely inside one part (guaranteed by the
            # balancer's cut-margin rule)
            if (m0, m1) != ranges[ax]:
                raise NotImplementedError(
                    "cut passes through a connected face's ghost depth "
                    "(choose a cut >= 2 cells from connected faces)")
            newrng = c.rng
        else:
            pos = t_axes.index(mstar)
            r = [list(rng[0]), list(rng[1])]
            r[pos] = [max(r[pos][0], m0), min(r[pos][1], m1)]
            if r[pos][0] >= r[pos][1]:
                continue
            newrng = (tuple(r[0]), tuple(r[1]))
        out.append(dataclasses.replace(
            c, donor_block=donor_idx, offset=tuple(off), rng=newrng))
    if not out:
        raise ValueError("donor remap produced no pieces (bad topology)")
    return out


def split_block(mesh: MultiBlockMesh, bi: int, axis: int, cut: int
                ) -> MultiBlockMesh:
    """Split block ``bi`` at interior cell index ``cut`` along ``axis``.

    Part 0 keeps cells [0, cut), part 1 (appended at the end) gets
    [cut, n). An internal 1-to-1 connection stitches them; every
    connection (of any block, including self-wraps) whose donor was ``bi``
    is remapped onto the parts, splitting into partial-face (``rng``)
    connections where the window straddles the cut
    (loadBalance.F90:880 donor remapping).
    """
    blk = mesh.blocks[bi]
    n = blk.dims[axis]
    if not (0 < cut < n):
        raise ValueError(f"cut {cut} outside (0, {n})")
    new_index = len(mesh.blocks)

    def part_block(part: int) -> Block:
        lo = 0 if part == 0 else cut
        hi = cut if part == 0 else n
        xsl = [slice(None)] * 3
        xsl[axis] = slice(lo, hi + 1)
        x = blk.x[tuple(xsl)]

        bcs: List[BCSubface] = []
        for sf in blk.bcs:
            ax = sf.face.axis
            if ax == axis:
                # stays with the part that owns that face
                if (sf.face.is_high and part == 1) or \
                        (not sf.face.is_high and part == 0):
                    bcs.append(dataclasses.replace(sf))
                continue
            o1, o2 = [a for a in range(3) if a != ax]
            rng = sf.rng or ((0, blk.dims[o1]), (0, blk.dims[o2]))
            r = [list(rng[0]), list(rng[1])]
            pos = 0 if o1 == axis else 1
            clipped = _clip_rng(tuple(r[pos]), lo, hi)
            if clipped is None:
                continue
            r[pos] = list(clipped)
            bcs.append(dataclasses.replace(
                sf, rng=(tuple(r[0]), tuple(r[1]))))

        conns: List[B2BConnection] = []
        for c in blk.conns:
            ax = c.face.axis
            donor = _OLD_DONOR if c.donor_block == bi else c.donor_block
            if ax == axis:
                if (c.face.is_high) != (part == 1):
                    continue
                off = list(c.offset)
                if part == 1:
                    # receiver renumbering: coords along the split axis
                    # shift by -cut; mine_old = mine_new + cut enters the
                    # affine map through the axis component's offset
                    s = 1 if c.transform[axis] > 0 else -1
                    off[axis] = off[axis] + s * cut
                conns.append(dataclasses.replace(
                    c, donor_block=donor, offset=tuple(off)))
                continue
            # lateral face: clip the window to this part, shift frame
            o1, o2 = [a for a in range(3) if a != ax]
            rng = c.rng or ((0, blk.dims[o1]), (0, blk.dims[o2]))
            r = [list(rng[0]), list(rng[1])]
            pos = 0 if o1 == axis else 1
            clipped = _clip_rng(tuple(r[pos]), lo, hi)
            if clipped is None:
                continue
            r[pos] = list(clipped)
            off = list(c.offset)
            if part == 1:
                s = 1 if c.transform[axis] > 0 else -1
                off[axis] = off[axis] + s * cut
            conns.append(dataclasses.replace(
                c, donor_block=donor, offset=tuple(off),
                rng=(tuple(r[0]), tuple(r[1]))))

        # internal stitch connection
        my_face = Face(2 * axis + (1 if part == 0 else 0))
        off = [0, 0, 0]
        off[axis] = -cut if part == 0 else cut
        conns.append(B2BConnection(
            face=my_face, donor_block=(new_index if part == 0 else bi),
            donor_face=Face(2 * axis + (0 if part == 0 else 1)),
            transform=(1, 2, 3), offset=tuple(off)))
        return Block(name=f"{blk.name}_s{part}", x=x, bcs=bcs, conns=conns)

    blocks = list(mesh.blocks)
    blocks[bi] = part_block(0)
    blocks.append(part_block(1))

    # phase B: remap every connection whose donor was the old block
    out_blocks: List[Block] = []
    for rbi, b in enumerate(blocks):
        newconns: List[B2BConnection] = []
        changed = False
        for c in b.conns:
            needs = (c.donor_block == _OLD_DONOR
                     or (c.donor_block == bi and rbi not in (bi, new_index)))
            if not needs:
                newconns.append(c)
                continue
            changed = True
            c0 = (dataclasses.replace(c, donor_block=bi)
                  if c.donor_block == _OLD_DONOR else c)
            newconns.extend(_remap_donor_conn(
                c0, b.dims, bi, new_index, axis, cut, n))
        out_blocks.append(
            dataclasses.replace(b, conns=newconns) if changed else b)
    return MultiBlockMesh(out_blocks, name=mesh.name)


def balance_blocks(mesh: MultiBlockMesh, n_chips: int,
                   max_imbalance: float = 1.25
                   ) -> Tuple[MultiBlockMesh, List[int]]:
    """Split oversized blocks and order them so chip c owns a contiguous,
    equal-count slice of the stacked block axis (greedy LPT assignment;
    reference: loadBalanceGrid, loadBalance.F90:5).

    Returns (mesh, order): ``order[pos]`` = original block index for stack
    position pos; dummy positions (padding to equal count) are -1.
    """
    m = mesh
    total = m.n_cells
    target = total / n_chips
    # split until no block exceeds max_imbalance * target (and we have at
    # least n_chips blocks)
    guard = 0
    while True:
        sizes = [b.n_cells for b in m.blocks]
        big = int(np.argmax(sizes))
        if (len(m.blocks) >= n_chips
                and sizes[big] <= max_imbalance * target):
            break
        blk = m.blocks[big]
        for axis in sorted(range(3), key=lambda a: -blk.dims[a]):
            if blk.dims[axis] < 2:
                continue
            try:
                m = split_block(m, big, axis, blk.dims[axis] // 2)
                break
            except NotImplementedError:
                continue
        else:
            break
        guard += 1
        if guard > 64:
            break

    # greedy LPT: biggest block to least-loaded chip
    sizes = [b.n_cells for b in m.blocks]
    order_desc = np.argsort(sizes)[::-1]
    bins: List[List[int]] = [[] for _ in range(n_chips)]
    loads = np.zeros(n_chips)
    for b in order_desc:
        c = int(np.argmin(loads))
        bins[c].append(int(b))
        loads[c] += sizes[b]
    per = max(len(bn) for bn in bins)
    order: List[int] = []
    for bn in bins:
        order.extend(bn + [-1] * (per - len(bn)))
    return m, order


# ---------------------------------------------------------------------------
# stacked problem
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class StackedProblem:
    """Static data for the stacked multi-block solve. The numpy fields are
    the JAX package's, over every slot; the tensors are this rank's slots
    on its device."""

    nb: int                                # stack length (incl. dummies)
    bucket: Tuple[int, int, int]           # bucket interior dims
    block_dims: Tuple[Tuple[int, int, int], ...]   # per-slot real dims
    active: Tuple[bool, ...]
    bc_ops: Tuple[tuple, ...]              # per-slot BCOp tuples
    halo: Optional[HaloTable]
    por: Tuple[np.ndarray, np.ndarray, np.ndarray]  # stacked (B, ...) masks
    mask: np.ndarray                       # (B, NI, NJ, NK) interior mask
    order: Tuple[int, ...]                 # stack slot -> original block
    group: object = None                   # process group, None: one device
    slots: Tuple[int, ...] = ()            # this rank's slots
    plan: Optional[comm.HaloPlan] = None   # this rank's share of ``halo``
    por_t: tuple = ()                      # its porosities, (per, ...)
    mask_t: Optional[torch.Tensor] = None  # its interior mask
    device: object = "cpu"


def build_stacked_problem(mesh: MultiBlockMesh,
                          order: Optional[Sequence[int]] = None,
                          group=None, dtype=torch.float64, device="cpu"
                          ) -> StackedProblem:
    """The stacked problem of ``mesh`` in slot ``order`` (all blocks in
    mesh order by default; -1 marks a dummy slot), and this rank's share
    of it in ``group`` with tensors in ``dtype`` on ``device``."""
    if order is None:
        order = list(range(len(mesh.blocks)))
    NI = max(b.dims[0] for b in mesh.blocks)
    NJ = max(b.dims[1] for b in mesh.blocks)
    NK = max(b.dims[2] for b in mesh.blocks)
    bucket = (NI, NJ, NK)
    nb = len(order)
    rank, size = comm.world(group)
    if nb % size:
        raise ValueError(f"{nb} slots do not split evenly over {size} ranks")
    per = nb // size

    # reorder blocks into stack order; the halo table must see the same
    # order, so build a reordered mesh (conn donor indices remapped)
    remap = {orig: pos for pos, orig in enumerate(order) if orig >= 0}
    stack_blocks: List[Optional[Block]] = []
    for orig in order:
        if orig < 0:
            stack_blocks.append(None)
            continue
        blk = mesh.blocks[orig]
        conns = [dataclasses.replace(c, donor_block=remap[c.donor_block])
                 for c in blk.conns]
        stack_blocks.append(dataclasses.replace(blk, conns=conns))

    # dummy slots have no connections: unit blocks stand in for them
    def unit_block(i):
        x = np.zeros((2, 2, 2, 3))
        x[..., 0] = np.arange(2)[:, None, None]
        x[..., 1] = np.arange(2)[None, :, None]
        x[..., 2] = np.arange(2)[None, None, :]
        return Block(name=f"dummy{i}", x=x, bcs=[], conns=[])

    mesh_stacked = MultiBlockMesh(
        [b if b is not None else unit_block(i)
         for i, b in enumerate(stack_blocks)], name=mesh.name)
    halo = build_halo_table(mesh_stacked,
                            padded_shape=(NI + 2 * H, NJ + 2 * H, NK + 2 * H))

    porI = np.zeros((nb, NI + 1, NJ, NK), np.float32)
    porJ = np.zeros((nb, NI, NJ + 1, NK), np.float32)
    porK = np.zeros((nb, NI, NJ, NK + 1), np.float32)
    mask = np.zeros((nb, NI, NJ, NK), np.float32)
    bc_ops = []
    dims_out = []
    active = []
    for i, b in enumerate(stack_blocks):
        if b is None:
            bc_ops.append(())
            dims_out.append((1, 1, 1))
            active.append(False)
            continue
        ni, nj, nk = b.dims
        pi, pj, pk = _build_porosities(b)
        porI[i, :ni + 1, :nj, :nk] = pi
        porJ[i, :ni, :nj + 1, :nk] = pj
        porK[i, :ni, :nj, :nk + 1] = pk
        mask[i, :ni, :nj, :nk] = 1.0
        bc_ops.append(tuple(build_bc_ops(b)))
        dims_out.append(b.dims)
        active.append(True)
    mine = slice(rank * per, (rank + 1) * per)
    return StackedProblem(
        nb=nb, bucket=bucket, block_dims=tuple(dims_out),
        active=tuple(active), bc_ops=tuple(bc_ops), halo=halo,
        por=(porI, porJ, porK), mask=mask, order=tuple(order),
        group=group, slots=tuple(range(nb))[mine],
        plan=(None if halo is None
              else comm.halo_plan(halo, nb, group, device)),
        por_t=tuple(torch.as_tensor(p[mine], dtype=dtype, device=device)
                    for p in (porI, porJ, porK)),
        mask_t=torch.as_tensor(mask[mine], dtype=dtype, device=device),
        device=torch.device(device))


def stack_metrics(mesh: MultiBlockMesh, prob: StackedProblem, dtype,
                  metrics_all=None) -> BlockMetrics:
    """This rank's per-slot metrics embedded at the low corner of
    bucket-shaped arrays, with the true ghost metrics at b2b faces
    (``compute_metrics_conn``, computed here unless ``metrics_all`` gives
    them per original block).

    Pad region: unit volumes, zero face areas, distinct pad coordinates, so
    fluxes vanish there, nothing divides by zero and face-gradient
    distances never vanish; the residual mask removes any leftovers.
    """
    NI, NJ, NK = prob.bucket
    per, dev = len(prob.slots), prob.device
    siE = torch.zeros((per, NI + 3, NJ + 2, NK + 2, 3), dtype=dtype,
                      device=dev)
    sjE = torch.zeros((per, NI + 2, NJ + 3, NK + 2, 3), dtype=dtype,
                      device=dev)
    skE = torch.zeros((per, NI + 2, NJ + 2, NK + 3, 3), dtype=dtype,
                      device=dev)
    vol = torch.ones((per, NI + 4, NJ + 4, NK + 4), dtype=dtype, device=dev)
    ar = [1e3 + torch.arange(n + 2, dtype=dtype, device=dev)
          for n in (NI, NJ, NK)]
    xc = torch.stack(torch.meshgrid(*ar, indexing="ij"), dim=-1)
    xc = xc.expand((per,) + tuple(xc.shape)).clone()
    if metrics_all is None:
        metrics_all = compute_metrics_conn(
            mesh.blocks, [torch.as_tensor(b.x, dtype=dtype, device=dev)
                          for b in mesh.blocks])
    for b, pos in enumerate(prob.slots):
        orig = prob.order[pos]
        if orig < 0:
            continue
        m = metrics_all[orig]
        ni, nj, nk = mesh.blocks[orig].dims
        siE[b, :ni + 3, :nj + 2, :nk + 2] = m.siE
        sjE[b, :ni + 2, :nj + 3, :nk + 2] = m.sjE
        skE[b, :ni + 2, :nj + 2, :nk + 3] = m.skE
        vol[b, :ni + 4, :nj + 4, :nk + 4] = m.vol
        xc[b, :ni + 2, :nj + 2, :nk + 2] = m.xc_ext
    return BlockMetrics(siE=siE, sjE=sjE, skE=skE, vol=vol, xc_ext=xc)


def stack_state(prob: StackedProblem, winf, dtype) -> torch.Tensor:
    """This rank's slots, every cell at the free stream."""
    NI, NJ, NK = prob.bucket
    winf = torch.as_tensor(winf, dtype=torch.float64)
    return winf.expand((len(prob.slots), NI + 4, NJ + 4, NK + 4,
                        winf.shape[0])).to(dtype=dtype,
                                           device=prob.device).clone()


def stack_walldist(mesh: MultiBlockMesh, prob: StackedProblem, d_by_orig,
                   dtype) -> torch.Tensor:
    """This rank's slots of the per-original-block wall distances
    (one-ring ext arrays); 1 in the pad."""
    NI, NJ, NK = prob.bucket
    out = torch.ones((len(prob.slots), NI + 2, NJ + 2, NK + 2),
                     dtype=dtype, device=prob.device)
    for b, pos in enumerate(prob.slots):
        orig = prob.order[pos]
        if orig < 0:
            continue
        ni, nj, nk = mesh.blocks[orig].dims
        out[b, :ni + 2, :nj + 2, :nk + 2] = torch.as_tensor(
            d_by_orig[orig], dtype=dtype, device=prob.device)
    return out


def _slot_metrics(sm: BlockMetrics, b: int) -> BlockMetrics:
    return BlockMetrics(siE=sm.siE[b], sjE=sm.sjE[b], skE=sm.skE[b],
                        vol=sm.vol[b], xc_ext=sm.xc_ext[b])


def _active(prob: StackedProblem, b: int) -> bool:
    return prob.active[prob.slots[b]]


def _with_interior(w, interior):
    """Copy of the padded stack ``w`` whose interiors are ``interior``."""
    out = w.clone()
    out[:, 2:-2, 2:-2, 2:-2] = interior
    return out


def fill_halos_stacked(w, sm: BlockMetrics, prob: StackedProblem,
                       ref: ReferenceState, winf) -> torch.Tensor:
    """BC -> b2b exchange -> BC on this rank's slots (the ordered corner
    fill of physics/residual.py fill_halos, with one exchange for all
    connections; reference: whalo2 + applyAllBC ordering)."""
    def bc_pass(w):
        out = []
        for b, pos in enumerate(prob.slots):
            ops = prob.bc_ops[pos]
            out.append(apply_bcs(w[b], _slot_metrics(sm, b), ops, ref, winf)
                       if ops else w[b])
        return torch.stack(out)

    w = bc_pass(w)
    if prob.halo is not None:
        w = comm.exchange(w, prob.plan)
        w = bc_pass(w)
    return w


def stacked_residual(w, sm: BlockMetrics, prob: StackedProblem,
                     cfg: ProblemConfig, ref: ReferenceState, winf,
                     extras=None, fill: bool = True) -> torch.Tensor:
    """Masked residual (per, NI, NJ, NK, nw) of this rank's slots: one
    ``block_residual`` per real slot, zeros for a dummy one."""
    if fill:
        w = fill_halos_stacked(w, sm, prob, ref, winf)
    d = None if extras is None else extras.get("walldist")
    NI, NJ, NK = prob.bucket
    out = []
    for b in range(len(prob.slots)):
        if not _active(prob, b):
            out.append(w.new_zeros((NI, NJ, NK, w.shape[-1])))
            continue
        ex = None if d is None else {"walldist": d[b]}
        out.append(block_residual(
            w[b], _slot_metrics(sm, b), cfg, ref, ex,
            por=tuple(p[b] for p in prob.por_t)))
    r = torch.stack(out)
    # select, not multiply (module docstring)
    return torch.where(prob.mask_t[..., None] > 0, r, 0.0)


def _norm_pair(r0, prob: StackedProblem, nmf: int = 5):
    nm = comm.global_norm(r0[..., :nmf], prob.group)
    nt = (comm.global_norm(r0[..., nmf:], prob.group)
          if r0.shape[-1] > nmf else torch.zeros_like(nm))
    return torch.stack([nm, nt])


def make_stacked_rk_step(prob: StackedProblem, cfg: ProblemConfig,
                         ref: ReferenceState, cfl: float = 1.5,
                         coeffs=RK_COEFFS):
    """One multistage RK iteration over this rank's slots (mirrors
    solvers/smoothers.py rk_iteration): ``step(w, sm, winf, extras=None)``
    returns the new slots and the global (mean-flow, turbulence) norms of
    the first stage's residual."""

    def step(w, sm, winf, extras=None):
        w0 = fill_halos_stacked(w, sm, prob, ref, winf)
        mask = prob.mask_t[..., None]
        NI, NJ, NK = prob.bucket
        dt, diag = [], []
        sa_diag = (cfg.rans and cfg.turbulence_model == "sa"
                   and extras is not None)
        if sa_diag:
            from adflow_torch.physics.sa import sa_destruction_diag
        for b in range(len(prob.slots)):
            if not _active(prob, b):
                dt.append(w.new_zeros((NI, NJ, NK)))
                diag.append(w.new_zeros((NI, NJ, NK)))
                continue
            smb = _slot_metrics(sm, b)
            dt.append(local_timestep(w0[b], pressure(w0[b]), smb, cfl, cfg,
                                     ref))
            if sa_diag:
                diag.append(sa_destruction_diag(w0[b], smb,
                                                extras["walldist"][b]))
        dtv = torch.stack(dt) / sm.vol[:, 2:-2, 2:-2, 2:-2]
        # pad/dummy cells have zero face areas -> infinite local dt; zero
        # dtv there so the masked update stays finite
        dtv = torch.where(mask[..., 0] > 0, dtv, 0.0)
        diag = torch.stack(diag) if sa_diag else None

        nmf = 5
        inv_ts = None
        if cfg.rans and any(s != 1.0 for s in cfg.turb_scales):
            inv_ts = torch.tensor([1.0 / s for s in cfg.turb_scales],
                                  dtype=w.dtype, device=w.device)
        r0 = None
        wk = w0
        for alpha in coeffs:
            r = stacked_residual(wk, sm, prob, cfg, ref, winf, extras,
                                 fill=False)
            if r0 is None:
                r0 = r
            if r.shape[-1] > nmf and (diag is not None or inv_ts is not None):
                rt = r[..., nmf:]
                if inv_ts is not None:
                    rt = rt * inv_ts
                if diag is not None:
                    rt = rt / (1.0 + alpha * dtv * diag)[..., None]
                r = torch.cat([r[..., :nmf], rt], dim=-1)
            upd = w0[:, 2:-2, 2:-2, 2:-2] - alpha * dtv[..., None] * r * mask
            wk = fill_halos_stacked(_with_interior(w0, upd), sm, prob, ref,
                                    winf)
        return wk, _norm_pair(r0, prob)

    return step


def stacked_ank_step(w, sm, prob: StackedProblem, cfg: ProblemConfig,
                     ref: ReferenceState, winf, cfl, extras=None,
                     m: int = 20, lintol: float = 0.05):
    """One ANK step on this rank's slots: backward-Euler diagonal +
    matrix-free GMRES over the process group (mirrors solvers/newton.py
    make_ank_step; the reference's parallel PETSc KSP). Every rank takes
    the same decisions: the norms, the physicality limit and the line
    search read reduced values only. Returns (new slots, ||R|| before,
    ||R|| after, relative linear residual)."""
    from adflow_torch.physics.fluxes import spectral_radii
    from adflow_torch.physics.timestep import viscous_spectral_radii
    from adflow_torch.solvers.krylov import gmres
    from adflow_torch.solvers.linpc import build_line_pc, line_pc_apply

    group = prob.group
    NI, NJ, NK = prob.bucket
    per = len(prob.slots)
    nw = w.shape[-1]
    shape = (per, NI, NJ, NK, nw)
    maskv = prob.mask_t[..., None]

    def res_flat(wvec):
        ws = _with_interior(w, wvec.reshape(shape))
        return stacked_residual(ws, sm, prob, cfg, ref, winf,
                                extras).reshape(-1)

    wvec = w[:, 2:-2, 2:-2, 2:-2].reshape(-1)
    r = res_flat(wvec)
    rnorm = float(comm.global_norm(r, group))

    wf = fill_halos_stacked(w, sm, prob, ref, winf)

    def rad(wb, smb):
        p = torch.clamp(pressure(wb), min=1e-10)
        rI, rJ, rK = spectral_radii(wb, p, smb, cfg.ls_precon_mach)
        rs = (rI + rJ + rK)[1:-1, 1:-1, 1:-1]
        if cfg.viscous:
            rv = viscous_spectral_radii(wb, smb, cfg, ref)
            rs = rs + 4.0 * (rv[0] + rv[1] + rv[2])
        return rs

    rs = torch.stack([rad(wf[b], _slot_metrics(sm, b)) if _active(prob, b)
                      else w.new_zeros((NI, NJ, NK)) for b in range(per)])
    chan = torch.ones((nw,), dtype=w.dtype, device=w.device)
    rsv = cfg.row_scale(w.dtype, w.device)
    if rsv is not None:
        chan = chan * rsv
    # pad cells: diag = 1, residual = 0 -> those DOFs solve to 0 exactly
    diag_cells = torch.where(prob.mask_t > 0, rs / cfl, 1.0)
    diag = (diag_cells[..., None] * chan * torch.clamp(maskv, min=0.0)
            + (1.0 - maskv)).reshape(-1)

    def matvec(v):
        _, jv = torch.func.jvp(res_flat, (wvec,), (v,))
        return diag * v + jv

    # the line PC built and applied per slot (under the JAX package's
    # sharded jit each device factors only its own slots: the reference's
    # per-rank ASM+ILU locality); pad rows and dummy slots pass through
    pcs = [build_line_pc(wf[b], _slot_metrics(sm, b), cfg, ref,
                         dtinv=rs[b] / cfl, axes=(1, 0, 2), kappa=0.25)
           if _active(prob, b) else None for b in range(per)]

    def precond(v):
        vb = v.reshape(shape)
        out = torch.stack([line_pc_apply(pc, vb[b]) if pc is not None
                           else vb[b] for b, pc in enumerate(pcs)])
        return torch.where(maskv > 0, out, vb).reshape(-1)

    sol = gmres(matvec, -r, m=m, restarts=2, tol=lintol, precond=precond,
                group=group)

    dw = sol.x.reshape(shape)
    wi = wvec.reshape(shape)
    msk = prob.mask_t
    lims = []
    for idx in (IRHO, IRHOE):
        lims.append(torch.max(msk * torch.abs(dw[..., idx])
                              / torch.clamp(torch.abs(wi[..., idx]),
                                            min=1e-12)))
    if nw > 5:
        lims.append(torch.max(msk * (-dw[..., 5])
                              / torch.clamp(torch.abs(wi[..., 5]),
                                            min=1e-12)))
    lims = comm.all_max(torch.stack(lims), group).tolist()
    alpha0 = 1.0
    for rel in lims[:2]:
        alpha0 = min(alpha0, 0.2 / max(rel, 0.2))
    if nw > 5:
        alpha0 = min(alpha0, 0.99 / max(lims[2], 0.99))

    def merit(a):
        return float(comm.global_norm(
            diag * (a * sol.x) + res_flat(wvec + a * sol.x), group))

    alphas = [alpha0, 0.5 * alpha0, 0.25 * alpha0]
    merits = np.array([merit(a) for a in alphas])
    alpha = alphas[int(np.argmin(np.where(np.isfinite(merits), merits,
                                          np.inf)))]
    wnew_vec = wvec + alpha * sol.x
    rnew = float(comm.global_norm(res_flat(wnew_vec), group))
    w_out = _with_interior(w, wnew_vec.reshape(shape))
    return w_out, rnorm, rnew, sol.res_norm / max(sol.b_norm, 1e-30)


def stack_from_list(prob: StackedProblem, w_list, winf,
                    dtype) -> torch.Tensor:
    """This rank's slots of the per-block (halo-padded) states (dummy
    slots and pad cells hold free stream)."""
    w = stack_state(prob, winf, dtype)
    for b, pos in enumerate(prob.slots):
        orig = prob.order[pos]
        if orig < 0:
            continue
        ni, nj, nk = prob.block_dims[pos]
        w[b, 2:2 + ni, 2:2 + nj, 2:2 + nk] = torch.as_tensor(
            w_list[orig][2:-2, 2:-2, 2:-2], dtype=dtype, device=w.device)
    return w


def unstack_to_list(prob: StackedProblem, w, w_list):
    """Scatter the interiors of the whole stack ``w`` (every slot; see
    ``comm.gather_stack``) back into the per-block state list."""
    out = list(w_list)
    for pos, orig in enumerate(prob.order):
        if orig < 0:
            continue
        ni, nj, nk = prob.block_dims[pos]
        blk = w_list[orig].clone()
        blk[2:-2, 2:-2, 2:-2] = w[pos, 2:2 + ni, 2:2 + nj, 2:2 + nk].to(
            dtype=blk.dtype, device=blk.device)
        out[orig] = blk
    return out
