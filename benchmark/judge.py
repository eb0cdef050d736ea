"""What the checks share: the plain reference of a cell's configuration on
the cell's mesh, and small comparisons."""

from __future__ import annotations

import math

import numpy as np
import torch

from benchmark import program, wing
from benchmark.reference import Reference
from benchmark.reference import mesh as rmesh


def reference(ctx, spec: dict, dtype=torch.float64) -> Reference:
    """The reference of the cell's configuration on the mesh ``spec`` (the
    same coordinates and boundaries the program was handed), on the run's
    device."""
    config = ctx.cell.config
    return Reference(wing.build_mesh(spec, rmesh), config["conditions"],
                     program.options(config), dtype=dtype,
                     device=ctx.device)


def sample(seed: int, n: int, salt: int = 0) -> int:
    """An index in [0, n) drawn from the run's seed."""
    return int(np.random.default_rng([seed % (1 << 64), salt]).integers(0, n))


def interior(w_list) -> torch.Tensor:
    """The flat interior states of halo-padded blocks, as ``getStates``."""
    return torch.cat([w[2:-2, 2:-2, 2:-2].reshape(-1) for w in w_list])


def rel_gap(a: float, b: float) -> float:
    """|a - b| / |b|."""
    return abs(a - b) / max(abs(b), 1e-300)


def worst(values) -> float:
    """The largest of ``values``, NaN if any is NaN (a reading that is not
    a number must not vanish in a max)."""
    values = [float(v) for v in values]
    if any(math.isnan(v) for v in values):
        return float("nan")
    return max(values) if values else float("nan")
