"""Carry state across from the JAX package.

Functions that take the JAX package's arrays as numpy (``np.asarray`` of a
jax array) and return the port's objects on a given device and dtype, so
one state can be fed through both packages. Nothing here imports JAX.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from adflow_torch.core.refstate import ReferenceState
from adflow_torch.geom.metrics import BlockMetrics


def _tensor(a, device, dtype):
    return torch.tensor(np.asarray(a), dtype=dtype, device=device)


def state_from_numpy(w_list, device="cpu", dtype=torch.float64):
    """Padded per-block states (ni+4, nj+4, nk+4, nw) as tensors."""
    return [_tensor(w, device, dtype) for w in w_list]


def metrics_from_numpy(siE, sjE, skE, vol, xc_ext, device="cpu",
                       dtype=torch.float64) -> BlockMetrics:
    """A ``BlockMetrics`` from the JAX package's metric arrays."""
    return BlockMetrics(*(_tensor(a, device, dtype)
                          for a in (siE, sjE, skE, vol, xc_ext)))


def line_pc_from_numpy(axes, mean, turb, dscalar, turb_scale=None,
                       device="cpu", dtype=torch.float64):
    """The port's ``LinePCData`` from the fields of the JAX package's one
    (as numpy): ``mean`` a list of (L, D, U) per axis, ``turb`` a list of
    (lt, dt, ut) or None per axis. The port keeps the factors of these
    operators, which it computes here as ``build_line_pc`` does."""
    from adflow_torch.solvers.linpc import line_pc_data

    def ops(t):
        return None if t is None else tuple(_tensor(a, device, dtype)
                                            for a in t)

    return line_pc_data(axes, [ops(t) for t in mean],
                        [ops(t) for t in turb],
                        _tensor(dscalar, device, dtype),
                        None if turb_scale is None else tuple(turb_scale))


def amg_pc_from_numpy(line, ops, factors, axis, n_smooth, coarse_damp=0.6,
                      transposed=False, device="cpu", dtype=torch.float64):
    """The port's ``AMGPCData`` from the fields of the JAX package's one
    (as numpy): ``line`` the keyword arguments of ``line_pc_from_numpy``
    (axes, mean, turb, dscalar, turb_scale) for its line PC, ``ops`` one
    dict per level with the ``StencilOp`` fields D, L, U, Dt, Lt, Ut
    (tuples per axis, or None) and turb_scale."""
    from adflow_torch.solvers.amg import AMGPCData, StencilOp

    def opt(a):
        return None if a is None else _tensor(a, device, dtype)

    def per_axis(t):
        return None if t is None else tuple(_tensor(a, device, dtype)
                                            for a in t)

    stencils = tuple(StencilOp(
        D=_tensor(op["D"], device, dtype), L=per_axis(op["L"]),
        U=per_axis(op["U"]), Dt=opt(op.get("Dt")),
        Lt=per_axis(op.get("Lt")), Ut=per_axis(op.get("Ut")),
        turb_scale=(None if op.get("turb_scale") is None
                    else tuple(op["turb_scale"])))
        for op in ops)
    return AMGPCData(
        line=line_pc_from_numpy(**line, device=device, dtype=dtype),
        ops=stencils, factors=tuple(tuple(f) for f in factors),
        axis=int(axis), n_smooth=int(n_smooth),
        coarse_damp=float(coarse_damp), transposed=bool(transposed))


def refstate_from_dict(fields) -> ReferenceState:
    """A ``ReferenceState`` from the fields of the JAX package's one
    (``dataclasses.asdict(ref)``); array fields become numpy arrays."""
    names = {f.name for f in dataclasses.fields(ReferenceState)}
    kw = {k: (np.asarray(v) if np.ndim(v) > 0 else v)
          for k, v in dict(fields).items() if k in names}
    return ReferenceState(**kw)


def params_from_numpy(params, device="cpu", dtype=torch.float64):
    """The adjoint's design variables from the JAX package's ``_ap_params``
    dict (its values as numpy): each a tensor on ``device``."""
    return {k: _tensor(v, device, dtype) for k, v in dict(params).items()}


def overset_table_from_numpy(table, dtype=torch.float64, device="cpu"):
    """The port's device overset table (``overset.assembly.device_table``)
    from the JAX package's ``OversetTable``: its groups' ``dst_block``,
    ``src_block``, ``dst_flat``, ``src_flat``, ``weights`` and
    ``priority``, its ``iblank`` arrays and ``n_orphans``."""
    from adflow_torch.overset.assembly import (
        OversetGroup, OversetTable, device_table)

    groups = tuple(OversetGroup(
        dst_block=int(g.dst_block), src_block=int(g.src_block),
        dst_flat=np.asarray(g.dst_flat), src_flat=np.asarray(g.src_flat),
        weights=np.asarray(g.weights), priority=int(g.priority))
        for g in table.groups)
    host = OversetTable(groups=groups,
                        iblank=tuple(np.asarray(b) for b in table.iblank),
                        n_orphans=int(table.n_orphans))
    return device_table(host, dtype, device)
