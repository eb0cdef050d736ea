"""Precision policy (counterpart of adflow_tpu/utils/dtypes.py).

'auto' = float64 on the CPU (tests, parity against the JAX package) and
float32 on CUDA (the kernels are f32 only), overridable per solver via the
``precision`` option.
"""

from __future__ import annotations

import torch


def resolve_dtype(precision: str = "auto", device=None) -> torch.dtype:
    p = precision.lower()
    if p == "float64":
        return torch.float64
    if p in ("float32", "tf32", "mixed"):
        # 'mixed': f32 working dtype (the f64 Newton endgame of the JAX
        # package is not part of this port yet)
        return torch.float32
    dev = torch.device(device) if device is not None else torch.device("cpu")
    return torch.float64 if dev.type == "cpu" else torch.float32
