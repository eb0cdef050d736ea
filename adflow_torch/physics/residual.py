"""Residual assembly: the single canonical R(w, x) pipeline (counterpart of
adflow_tpu/physics/residual.py).

Pipeline per evaluation:
  physical BCs -> b2b halo exchange [-> overset fringe interpolation]
  -> physical BCs (corner fix-up)
  -> per block: the fused RANS-SA kernel (ops/cuda_rans.py) on CUDA f32,
     else the inviscid fluxes: upwind or central + matrix dissipation
     (physics/upwind.py, plain), else central + JST (the inviscid kernel,
     ops/cuda_inviscid.py, on CUDA f32) [-> viscous -> turbulence:
     SA or SST] [-> actuator sources] -> R [* iblank mask on overset
     meshes: fringe and hole rows zeroed].
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from adflow_torch.core.mesh import WALL_BCS, BCType, MultiBlockMesh
from adflow_torch.core.refstate import ReferenceState
from adflow_torch.dist.halo import ConnOp, build_conn_ops, exchange_halos_list
from adflow_torch.geom.metrics import BlockMetrics
from adflow_torch.overset.assembly import (
    apply_overset, build_overset, device_table, iblank_masks)
from adflow_torch.physics.bc import BCOp, apply_bcs, build_bc_ops
from adflow_torch.physics.fluxes import inviscid_residual
from adflow_torch.physics.sa import second_order
from adflow_torch.physics.thermo import pressure
from adflow_torch.utils import trace


@dataclasses.dataclass(frozen=True)
class ProblemConfig:
    """Static problem definition for the residual pipeline (the JAX
    package's fields; ``use_pallas`` is ``use_kernels`` here)."""

    equation_type: str            # 'euler' | 'laminar ns' | 'rans'
    vis2: float
    vis4: float
    diss_exponent: float
    discretization: str = "central plus scalar dissipation"
    limiter: str = "van albada"
    entropy_fix: float = 0.05
    riemann_solver: str = "roe"
    turbulence_model: str = "sa"
    turb_order: str = "first order"
    # turbulence residual row scaling (reference turbResScale, sa.F90
    # saResScale:678); explicit updates divide it back out
    turb_res_scale: object = 1.0
    use_ft2: bool = True
    use_rotation_sa: bool = False
    use_qcr: bool = False
    coarse_level: bool = False
    ls_precon_mach: float = 0.0
    # route central-scalar f32 CUDA evaluations through the fused kernels
    # (reference useBlockettes, NKSolver/blockette.F90:70)
    use_kernels: bool = False

    @property
    def viscous(self) -> bool:
        return self.equation_type in ("laminar ns", "rans")

    @property
    def rans(self) -> bool:
        return self.equation_type == "rans"

    @property
    def n_turb(self) -> int:
        if not self.rans:
            return 0
        return 1 if self.turbulence_model.startswith("sa") else 2

    @property
    def turb_scales(self) -> tuple:
        """Per-turbulence-variable residual scale, length n_turb."""
        s = self.turb_res_scale
        t = (tuple(float(v) for v in s) if isinstance(s, (tuple, list))
             else (float(s),))
        while len(t) < self.n_turb:
            t = t + (t[-1],)
        return t[:self.n_turb]

    def row_scale(self, dtype=None, device=None):
        """(nw,) per-channel residual row scale [1]*5 + turb_scales, or None
        when no scaling is active."""
        if self.n_turb == 0 or all(s == 1.0 for s in self.turb_scales):
            return None
        return torch.tensor((1.0,) * 5 + self.turb_scales, dtype=dtype,
                            device=device)


@dataclasses.dataclass(frozen=True)
class BlockStatic:
    """Per-block static metadata (shapes, BC slices, face porosities and
    the overset compute mask as tensors on the solver's device)."""

    dims: Tuple[int, int, int]
    bc_ops: Tuple[BCOp, ...]
    por: Optional[tuple] = None   # (porI, porJ, porK) tensors
    # overset compute mask (ni, nj, nk, 1): 1 compute, 0 fringe/hole (the
    # reference's iblank, modules/block.F90 / oversetAPI.F90)
    iblank: Optional[torch.Tensor] = None


def _build_porosities(block) -> tuple:
    """Face porosity masks (numpy): 1 everywhere except 0 at solid-wall
    faces (reference setPorosities, preprocessingAPI.F90:524)."""
    ni, nj, nk = block.dims
    por = [np.ones((ni + 1, nj, nk)), np.ones((ni, nj + 1, nk)),
           np.ones((ni, nj, nk + 1))]
    for sf in block.bcs:
        if sf.bc not in WALL_BCS:
            continue
        ax = sf.face.axis
        t1, t2 = [a for a in range(3) if a != ax]
        dims = block.dims
        rng = sf.rng or ((0, dims[t1]), (0, dims[t2]))
        idx = [None, None, None]
        idx[ax] = dims[ax] if sf.face.is_high else 0
        idx[t1] = slice(rng[0][0], rng[0][1])
        idx[t2] = slice(rng[1][0], rng[1][1])
        por[ax][tuple(idx)] = 0.0
    return tuple(por)


@dataclasses.dataclass(frozen=True)
class MeshTopology:
    """All static topology for the residual: per-block metadata + exchange."""

    blocks: Tuple[BlockStatic, ...]
    conn_ops: Tuple[ConnOp, ...]
    # overset/assembly.py's OversetTable, its groups on the device
    # (``device_table``)
    overset: Optional[object] = None


def build_topology(mesh: MultiBlockMesh, cut_callback=None,
                   dtype=torch.float64, device="cpu") -> MeshTopology:
    """Static topology; porosities, the overset table's indices and weights
    and the iblank masks become tensors on ``device`` once, here. A mesh
    with an OVERSET face, or a ``cut_callback`` (block index, cell centres
    (n, 3)) -> hole mask, is assembled on the host by
    ``overset.assembly.build_overset``."""
    has_ovs = any(sf.bc is BCType.OVERSET
                  for b in mesh.blocks for sf in b.bcs)
    ovs = (build_overset(mesh, cut_callback=cut_callback)
           if (has_ovs or cut_callback is not None) else None)
    masks = iblank_masks(ovs, len(mesh.blocks), [b.dims for b in mesh.blocks])
    blocks = []
    for b, ib in zip(mesh.blocks, masks):
        por = tuple(torch.as_tensor(p, dtype=dtype, device=device)
                    for p in _build_porosities(b))
        blocks.append(BlockStatic(
            dims=b.dims, bc_ops=tuple(build_bc_ops(b)), por=por,
            iblank=(None if ib is None else
                    torch.as_tensor(ib, dtype=dtype, device=device))))
    return MeshTopology(blocks=tuple(blocks),
                        conn_ops=tuple(build_conn_ops(mesh)),
                        overset=device_table(ovs, dtype, device))


@trace.spanned("halo.fill")
def fill_halos(w_list, metrics_list, topo: MeshTopology,
               ref: ReferenceState, winf):
    """BC -> exchange [-> overset fringe update] -> BC sequence filling
    every ghost cell. The second BC pass makes every ghost a pure function
    of the interior (corner ghosts that no BC writes keep what the first
    pass and the exchange left). The overset update runs after the exchange
    (reference: wOverset inside whalo2, haloExchange.F90:1330), so donors
    read freshly exchanged values."""
    w_list = [apply_bcs(w, m, bs.bc_ops, ref, winf)
              for w, m, bs in zip(w_list, metrics_list, topo.blocks)]
    if topo.conn_ops:
        w_list = exchange_halos_list(w_list, topo.conn_ops)
    if topo.overset is not None:
        w_list = apply_overset(w_list, topo.overset)
    return [apply_bcs(w, m, bs.bc_ops, ref, winf)
            for w, m, bs in zip(w_list, metrics_list, topo.blocks)]


def _kernel_applies(w, metrics, cfg, extras, por) -> bool:
    """The conditions of adflow_tpu/physics/residual.py:217-227, plus a CUDA
    tensor and first-order turbulence advection: the JAX branch ignores
    ``turbulenceOrder`` (its kernel advects nuTilde to first order) while
    its plain path honours it, so the port keeps second-order runs on the
    plain path. Unlike the JAX branch, a multigrid coarse level's central
    scalar scheme (``coarse_level``: constant dissipation) takes K1 too,
    through its coarse instantiation."""
    return (cfg.use_kernels and cfg.rans and cfg.turbulence_model == "sa"
            and not second_order(cfg)
            and not cfg.use_rotation_sa
            and not cfg.use_qcr
            and cfg.discretization.startswith("central")
            and "matrix" not in cfg.discretization
            and por is not None and metrics.vfIE is None
            and w.dtype == torch.float32 and w.is_cuda
            and cfg.ls_precon_mach == 0.0
            and extras is not None and "walldist" in extras
            and "act_src" not in extras
            and "act_src_momentum" not in extras)


def _inviscid_kernel_applies(w, metrics, cfg, por) -> bool:
    """The conditions of adflow_tpu/physics/residual.py:249-250, plus a CUDA
    tensor and no low-speed preconditioner: the JAX branch ignores
    ``ls_precon_mach`` while its plain path honours it, so the port keeps
    such runs on the plain path."""
    return (cfg.use_kernels and not cfg.coarse_level and por is not None
            and metrics.vfIE is None and w.dtype == torch.float32
            and w.is_cuda and cfg.ls_precon_mach == 0.0)


def block_residual(w, metrics: BlockMetrics, cfg: ProblemConfig,
                   ref: ReferenceState, extras: Optional[dict] = None,
                   por=None):
    """Residual for one block with already-filled halos.

    Returns (ni, nj, nk, nw): net outflow flux per interior cell (the
    semi-discrete system is V dw/dt = -R).
    """
    if _kernel_applies(w, metrics, cfg, extras, por):
        from adflow_torch.ops.cuda_rans import fused_rans_residual
        return fused_rans_residual(
            w, metrics.siE, metrics.sjE, metrics.skE, metrics.vol,
            metrics.xc_ext, extras["walldist"], por[0], por[1], por[2],
            cfg.vis2, cfg.vis4, cfg.diss_exponent,
            ref.mu_inf, ref.t_inf_dim, cfg.use_ft2, cfg.turb_scales[0],
            coarse=cfg.coarse_level)

    p = pressure(w)
    if cfg.discretization.startswith("upwind"):
        from adflow_torch.physics.upwind import upwind_residual
        r = upwind_residual(w, p, metrics, cfg, por=por)
    elif "matrix" in cfg.discretization and not cfg.coarse_level:
        # central flux + |A_roe|-scaled JST blend (fluxes.F90
        # inviscidDissFluxMatrix:403); coarse levels take the constant
        # scalar dissipation below, as the reference's coarse variants do
        from adflow_torch.physics.upwind import matrix_dissipation_residual
        r = inviscid_residual(w, p, metrics, 0.0, 0.0, cfg.diss_exponent,
                              por=por)
        r = r + matrix_dissipation_residual(w, p, metrics, cfg, por=por)
    elif _inviscid_kernel_applies(w, metrics, cfg, por):
        # central + JST mean-flow part of Euler and laminar residuals (and
        # of RANS ones K1 does not cover) through the inviscid kernel
        from adflow_torch.ops.cuda_inviscid import fused_inviscid_residual
        w5 = w[..., :5].contiguous() if w.shape[-1] > 5 else w
        r = fused_inviscid_residual(
            w5, p, metrics.siE, metrics.sjE, metrics.skE, por[0], por[1],
            por[2], cfg.vis2, cfg.vis4, cfg.diss_exponent)
    else:
        r = inviscid_residual(w, p, metrics, cfg.vis2, cfg.vis4,
                              cfg.diss_exponent, por=por,
                              const_diss=cfg.coarse_level,
                              precon_mach=cfg.ls_precon_mach)
    if cfg.viscous:
        from adflow_torch.physics.viscous import viscous_residual
        r = r + viscous_residual(w, p, metrics, cfg, ref, extras=extras)
    if cfg.rans:
        d = extras["walldist"] if extras else None
        if cfg.turbulence_model.startswith("sst"):
            from adflow_torch.physics.sst import sst_residual
            rt = sst_residual(w, p, metrics, cfg, ref, d)
        else:
            from adflow_torch.physics.sa import sa_residual
            rt = sa_residual(w, p, metrics, cfg, ref, d)
        r = torch.cat([r, rt], dim=-1)
    if extras:
        r = _actuator_sources(r, w, extras)
    return r


def _actuator_sources(r, w, extras):
    """Subtract the actuator-region sources (sourceTerms_block,
    residuals.F90:348; V dw/dt = -R) from the mean-flow rows: ``act_src``,
    and ``act_src_momentum`` with its energy row f . u evaluated at the
    current state, once per evaluation, as the reference does."""
    r5 = r[..., :5]
    if "act_src" in extras:
        r5 = r5 - extras["act_src"]
    if "act_src_momentum" in extras:
        fm = extras["act_src_momentum"]
        wi = w[2:-2, 2:-2, 2:-2]
        en = torch.sum(fm[..., 1:4] * (wi[..., 1:4] / wi[..., 0:1]), dim=-1)
        r5 = r5 - torch.cat([torch.zeros_like(fm[..., :1]), fm[..., 1:4],
                             (fm[..., 4] + en)[..., None]], dim=-1)
    return torch.cat([r5, r[..., 5:]], dim=-1)


def residual_list(w_list, metrics_list, topo: MeshTopology,
                  cfg: ProblemConfig, ref: ReferenceState, winf,
                  extras_list: Optional[Sequence[dict]] = None):
    """Full multiblock residual: halo fill + per-block residuals. On an
    overset mesh each block's residual is multiplied by its iblank mask:
    the fringe and hole states are overwritten by interpolation every fill,
    so their rows are dead and GMRES stays regular in the compute
    subspace."""
    w_list = fill_halos(w_list, metrics_list, topo, ref, winf)
    out = []
    for i, (w, m) in enumerate(zip(w_list, metrics_list)):
        bs = topo.blocks[i]
        r = block_residual(w, m, cfg, ref,
                           extras_list[i] if extras_list else None,
                           por=bs.por)
        out.append(r if bs.iblank is None else r * bs.iblank)
    return out
