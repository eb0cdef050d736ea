"""The plain residual R(w, x) of one configuration: the halo fill (BCs,
block-to-block exchange, BCs again) and, per block, the central JST
inviscid residual, the viscous flux and the SA turbulence residual.

A frozen copy of the plain branches of adflow_torch's
``physics/residual.py`` (no kernel, no upwind or matrix dissipation, no
overset, no SST, no actuator sources: nothing the benchmark's
configurations run), so that the yardstick does not move when the
program does.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from .bc import BCOp, apply_bcs, build_bc_ops
from .fluxes import inviscid_residual
from .halo import ConnOp, build_conn_ops, exchange_halos_list
from .mesh import WALL_BCS, MultiBlockMesh
from .thermo import pressure


@dataclasses.dataclass(frozen=True)
class ProblemConfig:
    """The discretization the residual computes (the options of the
    configuration that reach it)."""

    equation_type: str            # 'euler' | 'laminar ns' | 'rans'
    vis2: float
    vis4: float
    diss_exponent: float
    turbulence_model: str = "sa"
    turb_order: str = "first order"
    turb_res_scale: float = 1.0
    use_ft2: bool = True
    use_rotation_sa: bool = False
    ls_precon_mach: float = 0.0

    @property
    def viscous(self) -> bool:
        return self.equation_type in ("laminar ns", "rans")

    @property
    def rans(self) -> bool:
        return self.equation_type == "rans"

    @property
    def n_turb(self) -> int:
        return 1 if self.rans else 0

    @property
    def turb_scales(self) -> tuple:
        return (float(self.turb_res_scale),) * self.n_turb


@dataclasses.dataclass(frozen=True)
class BlockStatic:
    dims: Tuple[int, int, int]
    bc_ops: Tuple[BCOp, ...]
    por: tuple


def _build_porosities(block) -> tuple:
    """Face porosity masks: 1 everywhere except 0 at solid-wall faces."""
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
    blocks: Tuple[BlockStatic, ...]
    conn_ops: Tuple[ConnOp, ...]


def build_topology(mesh: MultiBlockMesh, dtype=torch.float64,
                   device="cpu") -> MeshTopology:
    blocks = []
    for b in mesh.blocks:
        por = tuple(torch.as_tensor(p, dtype=dtype, device=device)
                    for p in _build_porosities(b))
        blocks.append(BlockStatic(dims=b.dims,
                                  bc_ops=tuple(build_bc_ops(b)), por=por))
    return MeshTopology(blocks=tuple(blocks),
                        conn_ops=tuple(build_conn_ops(mesh)))


def fill_halos(w_list, metrics_list, topo: MeshTopology, ref, winf):
    """BC -> exchange -> BC: every ghost cell a function of the interior."""
    w_list = [apply_bcs(w, m, bs.bc_ops, ref, winf)
              for w, m, bs in zip(w_list, metrics_list, topo.blocks)]
    if topo.conn_ops:
        w_list = exchange_halos_list(w_list, topo.conn_ops)
    return [apply_bcs(w, m, bs.bc_ops, ref, winf)
            for w, m, bs in zip(w_list, metrics_list, topo.blocks)]


def block_residual(w, metrics, cfg: ProblemConfig, ref,
                   extras: Optional[dict] = None, por=None):
    """Residual of one block with filled halos: (ni, nj, nk, nw), the net
    outflow flux per interior cell (V dw/dt = -R)."""
    p = pressure(w)
    r = inviscid_residual(w, p, metrics, cfg.vis2, cfg.vis4,
                          cfg.diss_exponent, por=por)
    if cfg.viscous:
        from .viscous import viscous_residual
        r = r + viscous_residual(w, p, metrics, cfg, ref, extras=extras)
    if cfg.rans:
        from .sa import sa_residual
        rt = sa_residual(w, p, metrics, cfg, ref,
                         extras["walldist"] if extras else None)
        r = torch.cat([r, rt], dim=-1)
    return r


def residual_list(w_list, metrics_list, topo: MeshTopology,
                  cfg: ProblemConfig, ref, winf,
                  extras_list: Optional[Sequence[dict]] = None):
    """Halo fill and every block's residual."""
    w_list = fill_halos(w_list, metrics_list, topo, ref, winf)
    return [block_residual(w, m, cfg, ref,
                           extras_list[i] if extras_list else None,
                           por=topo.blocks[i].por)
            for i, (w, m) in enumerate(zip(w_list, metrics_list))]
