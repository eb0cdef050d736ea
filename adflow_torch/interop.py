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
