"""Steady-state RK solve (counterpart of adflow_tpu/solvers/
steady.py; reference solveState, src/solver/solvers.F90:892).

The smoother loop runs in chunks of ``chunk`` iterations (the JAX package's
``lax.scan`` length) with the convergence, divergence and deadline checks
between chunks, so iteration counts match the JAX package exactly. Norms
stay on the device inside a chunk and are copied to the host once per
chunk.
"""

from __future__ import annotations

import time
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from adflow_torch.solvers.smoothers import residual_norms, rk_iteration


class SolveInfo(NamedTuple):
    converged: bool
    failed: bool
    iterations: int
    total_r0: float
    total_r_final: float
    history: np.ndarray  # (n, 2): mean-flow and turb residual norms


def solve_rk(w_list, metrics_list, topo, cfg, ref, winf,
             cfl: float = 1.5, n_cycles: int = 2000,
             l2_conv: float = 1e-8, l2_conv_rel: float = 1e-16,
             extras_list=None, chunk: int = 25,
             monitor: Optional[Callable] = None,
             total_r0: Optional[float] = None,
             smoother: str = "runge-kutta",
             deadline: Optional[float] = None):
    """Explicit RK smoother to steady state. Returns (w_list, SolveInfo).

    deadline: absolute time.time() after which the loop stops (reference:
    timeLimit option checked in solvers.F90:1136)."""
    if smoother.lower().startswith("dadi"):
        raise NotImplementedError("DADI smoother (ROADMAP.md queue 1 "
                                  "item 10)")
    hist_all = []
    it = 0
    r0 = total_r0
    failed = converged = False
    while it < n_cycles:
        rows = []
        for _ in range(chunk):
            w_list, r_list = rk_iteration(w_list, metrics_list, topo, cfg,
                                          ref, winf, cfl, extras_list)
            rows.append(torch.stack(residual_norms(r_list)))
        hist = torch.stack(rows).double().cpu().numpy()
        hist_all.append(hist)
        it += hist.shape[0]
        if r0 is None:
            r0 = float(hist[0, 0])
        rnow = float(hist[-1, 0])
        if monitor:
            monitor(it, rnow, float(hist[-1, 1]), w_list=w_list, cfl=cfl,
                    itertype="RK")
        if not np.isfinite(rnow):
            failed = True
            break
        if rnow <= l2_conv * r0 or rnow <= l2_conv_rel:
            converged = True
            break
        if deadline is not None and time.time() >= deadline:
            break
    hist_np = np.concatenate(hist_all) if hist_all else np.zeros((0, 2))
    info = SolveInfo(
        converged=converged, failed=failed, iterations=it,
        total_r0=float(r0 if r0 else 0.0),
        total_r_final=float(hist_np[-1, 0]) if len(hist_np) else float("nan"),
        history=hist_np)
    return w_list, info
