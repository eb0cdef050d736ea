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


def refstate_from_dict(fields) -> ReferenceState:
    """A ``ReferenceState`` from the fields of the JAX package's one
    (``dataclasses.asdict(ref)``); array fields become numpy arrays."""
    names = {f.name for f in dataclasses.fields(ReferenceState)}
    kw = {k: (np.asarray(v) if np.ndim(v) > 0 else v)
          for k, v in dict(fields).items() if k in names}
    return ReferenceState(**kw)
