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

from adflow_torch.solvers.smoothers import (
    dadi_iteration, residual_norms, rk_iteration)
from adflow_torch.utils import trace


class SolveInfo(NamedTuple):
    converged: bool
    failed: bool
    iterations: int
    total_r0: float
    total_r_final: float
    history: np.ndarray  # (n, 2): mean-flow and turb residual norms
    # per ANK/NK step records of the Newton driver (solvers/newton.py)
    steps: tuple = ()


def solve_rk(w_list, metrics_list, topo, cfg, ref, winf,
             cfl: float = 1.5, n_cycles: int = 2000,
             l2_conv: float = 1e-8, l2_conv_rel: float = 1e-16,
             extras_list=None, chunk: int = 25,
             monitor: Optional[Callable] = None,
             total_r0: Optional[float] = None,
             smoother: str = "runge-kutta",
             deadline: Optional[float] = None,
             signal_check: Optional[Callable] = None):
    """Explicit RK or DADI smoother to steady state. Returns (w_list,
    SolveInfo).

    smoother: 'runge-kutta' (RK5, smoothers.rk_iteration) or 'dadi'
    (diagonalized ADI, smoothers.dadi_iteration — reference DADISmoother,
    smoothers.F90:383).
    deadline: absolute time.time() after which the loop stops (reference:
    timeLimit option checked in solvers.F90:1136).
    signal_check: ``SignalMonitor.check`` (utils/signals.py), polled once a
    chunk with a provider of the current iterate; 'stop' ends the loop."""
    dadi = smoother.lower().startswith("dadi")
    iteration = dadi_iteration if dadi else rk_iteration
    itertype = "DADI" if dadi else "RK"
    hist_all = []
    it = 0
    r0 = total_r0
    failed = converged = False
    while it < n_cycles:
        rows = []
        for _ in range(chunk):
            with trace.span("smoother.cycle"):
                w_list, r_list = iteration(w_list, metrics_list, topo, cfg,
                                           ref, winf, cfl, extras_list)
            rows.append(torch.stack(residual_norms(r_list)))
        hist = torch.stack(rows).double().cpu().numpy()
        trace.host_sync()
        hist_all.append(hist)
        it += hist.shape[0]
        if r0 is None:
            r0 = float(hist[0, 0])
        rnow = float(hist[-1, 0])
        if monitor:
            monitor(it, rnow, float(hist[-1, 1]), w_list=w_list, cfl=cfl,
                    itertype=itertype)
        if not np.isfinite(rnow):
            failed = True
            break
        if rnow <= l2_conv * r0 or rnow <= l2_conv_rel:
            converged = True
            break
        if (signal_check is not None
                and signal_check(lambda: w_list) == "stop"):
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
