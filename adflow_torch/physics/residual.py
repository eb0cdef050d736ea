"""Residual assembly: the single canonical R(w, x) pipeline (counterpart of
adflow_tpu/physics/residual.py).

Pipeline per evaluation:
  physical BCs -> b2b halo exchange -> physical BCs (corner fix-up)
  -> per block: the fused RANS-SA kernel (ops/cuda_rans.py) on CUDA f32,
     else inviscid central+JST fluxes [-> viscous -> turbulence] -> R.
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
from adflow_torch.physics.bc import BCOp, apply_bcs, build_bc_ops
from adflow_torch.physics.fluxes import inviscid_residual
from adflow_torch.physics.thermo import pressure


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
    # route RANS-SA central-scalar f32 CUDA evaluations through the fused
    # kernel (reference useBlockettes, NKSolver/blockette.F90:70)
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
    """Per-block static metadata (shapes, BC slices, face porosities as
    tensors on the solver's device)."""

    dims: Tuple[int, int, int]
    bc_ops: Tuple[BCOp, ...]
    por: Optional[tuple] = None   # (porI, porJ, porK) tensors


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


def build_topology(mesh: MultiBlockMesh, cut_callback=None,
                   dtype=torch.float64, device="cpu") -> MeshTopology:
    """Static topology; porosities become ``dtype`` tensors on ``device``
    once, here. Overset meshes are not ported (ROADMAP.md queue 1 item 11)."""
    if cut_callback is not None or any(
            sf.bc is BCType.OVERSET for b in mesh.blocks for sf in b.bcs):
        raise NotImplementedError(
            "overset meshes (ROADMAP.md queue 1 item 11)")
    blocks = []
    for b in mesh.blocks:
        por = tuple(torch.as_tensor(p, dtype=dtype, device=device)
                    for p in _build_porosities(b))
        blocks.append(BlockStatic(dims=b.dims, bc_ops=tuple(build_bc_ops(b)),
                                  por=por))
    return MeshTopology(blocks=tuple(blocks),
                        conn_ops=tuple(build_conn_ops(mesh)))


def fill_halos(w_list, metrics_list, topo: MeshTopology,
               ref: ReferenceState, winf):
    """BC -> exchange -> BC sequence filling every ghost cell. The second BC
    pass makes every ghost a pure function of the interior (corner ghosts
    that no BC writes keep what the first pass and the exchange left)."""
    w_list = [apply_bcs(w, m, bs.bc_ops, ref, winf)
              for w, m, bs in zip(w_list, metrics_list, topo.blocks)]
    if topo.conn_ops:
        w_list = exchange_halos_list(w_list, topo.conn_ops)
    return [apply_bcs(w, m, bs.bc_ops, ref, winf)
            for w, m, bs in zip(w_list, metrics_list, topo.blocks)]


def _kernel_applies(w, metrics, cfg, extras, por) -> bool:
    """The conditions of adflow_tpu/physics/residual.py:217-227, plus a CUDA
    tensor."""
    return (cfg.use_kernels and cfg.rans and cfg.turbulence_model == "sa"
            and not cfg.use_rotation_sa and not cfg.coarse_level
            and not cfg.use_qcr
            and cfg.discretization.startswith("central")
            and "matrix" not in cfg.discretization
            and por is not None and metrics.vfIE is None
            and w.dtype == torch.float32 and w.is_cuda
            and cfg.ls_precon_mach == 0.0
            and extras is not None and "walldist" in extras
            and "act_src" not in extras
            and "act_src_momentum" not in extras)


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
            ref.mu_inf, ref.t_inf_dim, cfg.use_ft2, cfg.turb_scales[0])

    if (not cfg.discretization.startswith("central")
            or "matrix" in cfg.discretization or cfg.coarse_level):
        raise NotImplementedError(
            f"discretization {cfg.discretization!r} (ROADMAP.md queue 1 "
            f"item 9)")
    if extras and ("act_src" in extras or "act_src_momentum" in extras):
        raise NotImplementedError("actuator sources (ROADMAP.md queue 1 "
                                  "item 9)")
    p = pressure(w)
    # Euler and laminar runs take this plain path until the inviscid kernel
    # (K2, adflow_tpu/ops/pallas_residual.py) is ported
    r = inviscid_residual(w, p, metrics, cfg.vis2, cfg.vis4,
                          cfg.diss_exponent, por=por)
    if cfg.viscous:
        from adflow_torch.physics.viscous import viscous_residual
        r = r + viscous_residual(w, p, metrics, cfg, ref, extras=extras)
    if cfg.rans:
        if not cfg.turbulence_model.startswith("sa"):
            raise NotImplementedError("SST (ROADMAP.md queue 1 item 9)")
        from adflow_torch.physics.sa import sa_residual
        d = extras["walldist"] if extras else None
        r = torch.cat([r, sa_residual(w, p, metrics, cfg, ref, d)], dim=-1)
    return r


def residual_list(w_list, metrics_list, topo: MeshTopology,
                  cfg: ProblemConfig, ref: ReferenceState, winf,
                  extras_list: Optional[Sequence[dict]] = None):
    """Full multiblock residual: halo fill + per-block residuals."""
    w_list = fill_halos(w_list, metrics_list, topo, ref, winf)
    return [block_residual(w, m, cfg, ref,
                           extras_list[i] if extras_list else None,
                           por=topo.blocks[i].por)
            for i, (w, m) in enumerate(zip(w_list, metrics_list))]
