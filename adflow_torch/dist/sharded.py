"""The k-split of one structured block over ranks (counterpart of
adflow_tpu/dist/sharded.py; reference: ADflow's MPI domain decomposition
and halo exchange, loadBalance.F90:677, haloExchange.F90:5,109).

The global block (ni, nj, nk) is split along k into n_shards local blocks
(ni, nj, nk/n_shards), each carried halo-padded (ni+4, nj+4, nkl+4, nw).
The JAX package runs them under ``shard_map`` with ``ppermute`` rings;
here each rank runs its shard, and the ring is dist/comm.py's ``KRing``:
one ``batch_isend_irecv`` with every rank posting its operations, whose
backward is the reversed ring.

- Every shard runs the same program: all global BCs (the global kmin/kmax
  BCs included) are applied on every shard, the local b2b connections (the
  O-mesh i-wrap) are exchanged locally, and then the k-halos of shards that
  have a neighbour are overwritten with the neighbour's edge slabs. Shards
  without a neighbour keep their BC-filled values. This reproduces the
  ordered BC -> exchange corner fill of physics/residual.py fill_halos
  with the exchange crossing ranks.
- Scope: one global structured block, split along k; k-faces must not be
  solid walls (face porosities would differ per shard).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from adflow_torch.core.mesh import (
    WALL_BCS, BCSubface, Block, MultiBlockMesh)
from adflow_torch.core.refstate import ReferenceState
from adflow_torch.dist import comm
from adflow_torch.dist.halo import build_conn_ops, exchange_halos_list
from adflow_torch.geom.metrics import BlockMetrics
from adflow_torch.physics.bc import apply_bcs, build_bc_ops
from adflow_torch.physics.residual import (
    BlockStatic, MeshTopology, ProblemConfig, _build_porosities,
    block_residual)
from adflow_torch.physics.thermo import pressure
from adflow_torch.physics.timestep import local_timestep
from adflow_torch.solvers.smoothers import RK_COEFFS

H = 2


@dataclasses.dataclass(frozen=True)
class ShardedProblem:
    """Static data for a k-split solve."""

    group: object                  # process group over the shards, or None
    n_shards: int
    local_dims: Tuple[int, int, int]
    local_topo: MeshTopology       # identical on every shard
    # template local Block (shard 0) used to build BC ops / porosities
    template: Block


def _make_local_template(block: Block, n_shards: int) -> Block:
    """A local block (shard-sized) carrying ALL global BCs and the local b2b
    connections. Identical static metadata on every shard: global k-face BCs
    are applied everywhere and later overwritten by the ring where a
    neighbour exists."""
    ni, nj, nk = block.dims
    if nk % n_shards != 0:
        raise ValueError(f"nk={nk} not divisible by n_shards={n_shards}")
    nkl = nk // n_shards
    for sf in block.bcs:
        if sf.face.axis == 2 and sf.bc in WALL_BCS:
            raise NotImplementedError(
                "k-face wall BCs not supported in k-split mode (per-shard "
                "porosities would differ); rotate the mesh so walls are on "
                "i/j faces")
        if sf.rng is not None and sf.face.axis != 2:
            # subface ranges in the k direction would need per-shard clipping
            t1, t2 = [a for a in range(3) if a != sf.face.axis]
            krng = sf.rng[0] if t1 == 2 else sf.rng[1]
            if krng != (0, nk):
                raise NotImplementedError(
                    "k-partial subfaces not supported in k-split mode")
    for c in block.conns:
        if c.face.axis == 2:
            raise NotImplementedError(
                "k-face b2b connections not supported in k-split mode")
        if c.donor_block != 0:
            raise NotImplementedError("k-split mode takes a single block")

    def _clip_rng(sf: BCSubface) -> BCSubface:
        if sf.rng is None or sf.face.axis == 2:
            return dataclasses.replace(sf)
        t1, _t2 = [a for a in range(3) if a != sf.face.axis]
        (a0, a1), (b0, b1) = sf.rng
        if t1 == 2:
            a0, a1 = 0, nkl
        else:
            b0, b1 = 0, nkl
        return dataclasses.replace(sf, rng=((a0, a1), (b0, b1)))

    x_local = block.x[:, :, : nkl + 1]
    bcs = [_clip_rng(sf) for sf in block.bcs]
    conns = [dataclasses.replace(c) for c in block.conns]
    return Block(name=f"{block.name}_shard", x=x_local, bcs=bcs, conns=conns)


def build_sharded_problem(mesh: MultiBlockMesh, n_shards: int, group=None,
                          dtype=torch.float64, device="cpu"
                          ) -> ShardedProblem:
    """The k-split of ``mesh``'s one block into ``n_shards`` shards, run by
    the ranks of ``group`` (one shard each; None runs them on one device
    through ``n_shards == 1``)."""
    if len(mesh.blocks) != 1:
        raise NotImplementedError(
            "k-split sharding takes a single global block; multi-block "
            "meshes solve on the per-block list path")
    if comm.world(group)[1] != n_shards:
        raise ValueError(f"n_shards={n_shards} but the process group has "
                         f"{comm.world(group)[1]} ranks")
    template = _make_local_template(mesh.blocks[0], n_shards)
    shard_mesh = MultiBlockMesh([template], name="shard")
    por = tuple(torch.as_tensor(p, dtype=dtype, device=device)
                for p in _build_porosities(template))
    topo = MeshTopology(
        blocks=(BlockStatic(dims=template.dims,
                            bc_ops=tuple(build_bc_ops(template)), por=por),),
        conn_ops=tuple(build_conn_ops(shard_mesh)))
    return ShardedProblem(
        group=group, n_shards=n_shards, local_dims=template.dims,
        local_topo=topo, template=template)


def shard_arrays(mesh: MultiBlockMesh, prob: ShardedProblem, winf,
                 dtype=torch.float32, walldist=None, device="cpu"):
    """Host-side split of state/wall-distance into the stacked-shard layout.

    Returns (w_stack, d_stack):
      w_stack: (S, ni+4, nj+4, nkl+4, nw) free-stream initialized state
      d_stack: (S, ni+2, nj+2, nkl+2) wall distance on the one-ring grid
               (None unless walldist given, as (ni+2, nj+2, nk+2) global)
    A rank takes its shard, ``[rank]``.
    """
    blk = mesh.blocks[0]
    ni, nj, nk = blk.dims
    S = prob.n_shards
    nkl = nk // S
    winf = torch.as_tensor(winf, dtype=dtype, device=device)
    w_stack = winf.expand((S, ni + 4, nj + 4, nkl + 4,
                           winf.shape[0])).clone()
    d_stack = None
    if walldist is not None:
        d = torch.as_tensor(walldist, dtype=dtype, device=device)
        d_stack = torch.stack([d[:, :, s * nkl:(s + 1) * nkl + 2]
                               for s in range(S)])
    return w_stack, d_stack


def split_metrics(gm: BlockMetrics, n_shards: int, dtype=None
                  ) -> BlockMetrics:
    """Split GLOBAL BlockMetrics into stacked per-shard BlockMetrics whose
    extended (halo) entries carry the TRUE neighbour metrics at shard
    interfaces (the reference's xhalo coordinate exchange and halo metric
    computation), so every interface flux is the same on both sides. Pure
    slicing, so differentiable."""
    nk = gm.skE.shape[2] - 3
    S = n_shards
    nkl = nk // S

    def stack(a, extra):  # extra = trailing k extent beyond nkl
        out = torch.stack([a[:, :, s * nkl: s * nkl + nkl + extra]
                           for s in range(S)])
        return out if dtype is None else out.to(dtype)

    return BlockMetrics(
        siE=stack(gm.siE, 2), sjE=stack(gm.sjE, 2), skE=stack(gm.skE, 3),
        vol=stack(gm.vol, 4), xc_ext=stack(gm.xc_ext, 2))


def shard_of(stacked, s: int):
    """Shard ``s`` of a stacked tensor or BlockMetrics."""
    if isinstance(stacked, BlockMetrics):
        return BlockMetrics(*(None if a is None else a[s] for a in stacked))
    return stacked[s]


def exchange_k_halos(w, group):
    """Overwrite k-halos with neighbour edge slabs where a neighbour exists.

    w: local (ni+4, nj+4, nkl+4, nv) with BC-filled halos. The slabs carry
    the full (ni+4, nj+4) extent, so corner/edge halos inherit the
    neighbour's own BC-filled lateral halos (the ordered corner
    communication of haloExchange.F90 whalo2)."""
    if comm.world(group)[1] == 1:
        return w
    return comm.KRing.apply(w, group)


def fill_halos_sharded(w, metrics, prob: ShardedProblem,
                       ref: ReferenceState, winf):
    """BC -> local b2b -> BC -> the k ring (see module doc)."""
    topo = prob.local_topo
    bs = topo.blocks[0]
    w = apply_bcs(w, metrics, bs.bc_ops, ref, winf)
    if topo.conn_ops:
        (w,) = exchange_halos_list([w], topo.conn_ops)
        w = apply_bcs(w, metrics, bs.bc_ops, ref, winf)
    return exchange_k_halos(w, prob.group)


def sharded_residual(w, metrics, prob: ShardedProblem, cfg: ProblemConfig,
                     ref: ReferenceState, winf, extras=None):
    """Local residual with cross-rank halo fill. Shapes as block_residual."""
    w = fill_halos_sharded(w, metrics, prob, ref, winf)
    return block_residual(w, metrics, cfg, ref, extras,
                          por=prob.local_topo.blocks[0].por)


def sharded_norms(r, group, n_mean: int = 5):
    """Global residual 2-norms (reference: mpi_allreduce of norms,
    solvers.F90 convergenceInfo)."""
    s_mean = comm.all_sum(torch.sum(r[..., :n_mean] ** 2), group)
    if r.shape[-1] > n_mean:
        s_turb = comm.all_sum(torch.sum(r[..., n_mean:] ** 2), group)
    else:
        s_turb = torch.zeros((), dtype=r.dtype, device=r.device)
    return torch.sqrt(s_mean), torch.sqrt(s_turb)


def rk_iteration_sharded(w, metrics, prob: ShardedProblem, cfg: ProblemConfig,
                         ref, winf, cfl, extras=None,
                         coeffs: Sequence[float] = RK_COEFFS):
    """One multistage RK iteration on the local shard (cross-rank halos).
    Mirrors solvers/smoothers.py rk_iteration. Returns (w, r0, norms)."""
    w0 = fill_halos_sharded(w, metrics, prob, ref, winf)
    p = pressure(w0)
    dt = local_timestep(w0, p, metrics, cfl, cfg, ref)
    dtv = dt / metrics.vol[2:-2, 2:-2, 2:-2]
    por = prob.local_topo.blocks[0].por

    # point-implicit SA destruction damping, per cell as in
    # smoothers.rk_iteration, so partition invariance holds
    diag = None
    nmf = 5
    if cfg.rans and cfg.turbulence_model == "sa" and extras is not None:
        from adflow_torch.physics.sa import sa_destruction_diag
        diag = sa_destruction_diag(w0, metrics, extras["walldist"])
    inv_ts = None
    if cfg.rans and any(s != 1.0 for s in cfg.turb_scales):
        inv_ts = torch.tensor([1.0 / s for s in cfg.turb_scales],
                              dtype=w0.dtype, device=w0.device)

    r0 = None
    wk = w0
    for alpha in coeffs:
        r = block_residual(wk, metrics, cfg, ref, extras, por=por)
        if r0 is None:
            r0 = r
        if r.shape[-1] > nmf and (diag is not None or inv_ts is not None):
            rt = r[..., nmf:]
            if inv_ts is not None:
                rt = rt * inv_ts
            if diag is not None:
                rt = rt / (1.0 + alpha * dtv * diag)[..., None]
            r = torch.cat([r[..., :nmf], rt], dim=-1)
        upd = w0[2:-2, 2:-2, 2:-2] - alpha * dtv[..., None] * r
        wk = w0.clone()
        wk[2:-2, 2:-2, 2:-2] = upd
        wk = fill_halos_sharded(wk, metrics, prob, ref, winf)
    nm, nt = sharded_norms(r0, prob.group)
    return wk, r0, torch.stack([nm, nt])


def make_sharded_step(prob: ShardedProblem, cfg: ProblemConfig,
                      ref: ReferenceState, n_iters: int = 1,
                      cfl: float = 1.5):
    """Each rank's step: ``step(w, metrics, winf, d=None)`` on its shard
    (``shard_of`` the stacked arrays) runs ``n_iters`` RK iterations and
    returns (w, (n_iters, 2) history of the global norms)."""

    def step(w, metrics, winf, d=None):
        extras = None if d is None else {"walldist": d}
        hist = []
        for _ in range(n_iters):
            w, _r, norms = rk_iteration_sharded(w, metrics, prob, cfg, ref,
                                                winf, cfl, extras)
            hist.append(norms)
        return w, torch.stack(hist)

    return step
