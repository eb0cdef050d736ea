"""Time-accurate solvers: BDF1/2 dual-time stepping and explicit RK
(counterpart of adflow_tpu/solvers/unsteady.py).

Reference analogues (src/solver/solvers.F90):
- ``solverUnsteadyInit/Step`` (:124,317): BDF dual time. The unsteady
  residual R* = V/dt (c0 w + c1 w^n + c2 w^{n-1}) + R(w) enters the steady
  machinery through ``initres_block`` (residuals.F90:427) and is driven to
  zero in pseudo-time each physical step; ``setCoefTimeIntegrator``
  (utils/utils.F90:1535) picks the BDF coefficients.
- ``solverUnsteadyExplicitRK`` (:486): global-time-step RK4.
- ``shiftSolution`` (solverUtils.F90:2267): the history shift between
  steps.

One physical step is a Python loop of ``n_inner`` pseudo-time RK
iterations (the JAX package's ``lax.scan``), each of five residual
evaluations through the residual kernels where they apply; the first
step's BDF1 coefficients are a host branch (its ``lax.cond``). The inner
residual norms stay on the device and are copied to the host once a
step.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from adflow_torch.physics.residual import block_residual, fill_halos
from adflow_torch.physics.thermo import pressure
from adflow_torch.physics.timestep import local_timestep
from adflow_torch.solvers.smoothers import (
    RK_COEFFS, _with_interior, residual_norms)


class UnsteadyInfo(NamedTuple):
    n_steps: int
    times: np.ndarray
    inner_res: np.ndarray       # final pseudo-time residual per step
    failed: bool


def bdf_coefficients(order: int, first_step: bool):
    """(c0, c1, c2): V/dt (c0 w^{n+1} + c1 w^n + c2 w^{n-1})."""
    if order == 1 or first_step:
        return 1.0, -1.0, 0.0
    return 1.5, -2.0, 0.5


def unsteady_residual_list(w_list, wn_list, wnm1_list, metrics_list, topo,
                           cfg, ref, winf, dt, coefs, extras_list=None):
    """R*(w) = R(w) + V/dt (c0 w + c1 w^n + c2 w^{n-1}) per block
    (residuals.F90 initres_block, its BDF terms)."""
    c0, c1, c2 = coefs
    wf = fill_halos(w_list, metrics_list, topo, ref, winf)
    rsv = cfg.row_scale(w_list[0].dtype, w_list[0].device)
    out = []
    for i, (w, m) in enumerate(zip(wf, metrics_list)):
        ex = extras_list[i] if extras_list else None
        r = block_residual(w, m, cfg, ref, ex, por=topo.blocks[i].por)
        vol = m.vol[2:-2, 2:-2, 2:-2][..., None]
        acc = (c0 * w[2:-2, 2:-2, 2:-2]
               + c1 * wn_list[i][2:-2, 2:-2, 2:-2]
               + c2 * wnm1_list[i][2:-2, 2:-2, 2:-2])[..., :r.shape[-1]]
        if rsv is not None:
            # the turbulence rows of R carry turbResScale: scale the BDF
            # time term alike, so R* = S (V/dt acc + R) row-scales the
            # physical unsteady equations (the same zero set)
            acc = acc * rsv
        out.append(r + vol / dt * acc)
    return out


def make_dual_time_step(metrics_list, topo, cfg, ref, winf, dt,
                        order: int, extras_list=None, cfl: float = 2.0,
                        n_inner: int = 50):
    """One physical step by pseudo-time RK on R*: a function of
    (w_list, wn_list, wnm1_list, first_step) returning (w_list, the inner
    iterations' first-stage residual norms as one device tensor)."""

    def step(w_list, wn_list, wnm1_list, first_step):
        coefs = bdf_coefficients(order, bool(first_step))
        norms = []
        for _ in range(n_inner):
            w0 = fill_halos(w_list, metrics_list, topo, ref, winf)
            # the pseudo-step bounded by the physical step (dual-time rule)
            dt_list = [torch.clamp(local_timestep(w, pressure(w), m, cfl,
                                                  cfg, ref), max=0.75 * dt)
                       / m.vol[2:-2, 2:-2, 2:-2]
                       for w, m in zip(w0, metrics_list)]
            wk = w0
            r_first = None
            rsv = cfg.row_scale(w0[0].dtype, w0[0].device)
            for alpha in RK_COEFFS:
                r_list = unsteady_residual_list(
                    wk, wn_list, wnm1_list, metrics_list, topo, cfg, ref,
                    winf, dt, coefs, extras_list)
                if r_first is None:
                    r_first = r_list
                if rsv is not None:
                    # the explicit pseudo-update needs the physical residual
                    r_list = [r * (1.0 / rsv) for r in r_list]
                wk = fill_halos(
                    [_with_interior(w0b, w0b[2:-2, 2:-2, 2:-2]
                                    - alpha * dtv[..., None] * r)
                     for w0b, r, dtv in zip(w0, r_list, dt_list)],
                    metrics_list, topo, ref, winf)
            w_list = wk
            norms.append(residual_norms(r_first)[0])
        return w_list, torch.stack(norms)

    return step


def solve_unsteady_bdf(w_list, metrics_list, topo, cfg, ref, winf,
                       n_steps: int, dt: float, order: int = 2,
                       extras_list=None, cfl: float = 2.0,
                       n_inner: int = 50,
                       callback: Optional[Callable] = None):
    """BDF dual-time march (solvers.F90 solverUnsteadyStep loop).
    Returns (w_list, UnsteadyInfo)."""
    step = make_dual_time_step(metrics_list, topo, cfg, ref, winf, dt,
                               order, extras_list, cfl, n_inner)
    wn = list(w_list)
    wnm1 = list(w_list)
    inner_res = []
    times = []
    failed = False
    for n in range(n_steps):
        w_new, hist = step(w_list, wn, wnm1, n == 0)
        wnm1 = wn
        wn = w_new
        w_list = w_new
        rfin = float(hist[-1])
        inner_res.append(rfin)
        times.append((n + 1) * dt)
        if not np.isfinite(rfin):
            failed = True
            break
        if callback:
            callback(n, (n + 1) * dt, w_list)
    return w_list, UnsteadyInfo(
        n_steps=len(times), times=np.asarray(times),
        inner_res=np.asarray(inner_res), failed=failed)


def solve_unsteady_explicit_rk(w_list, metrics_list, topo, cfg, ref, winf,
                               n_steps: int, dt: float, extras_list=None,
                               callback: Optional[Callable] = None):
    """Explicit global-time-step RK4 (solvers.F90:486
    solverUnsteadyExplicitRK): the classical 4-stage scheme on
    dw/dt = -R/V, four residual evaluations a step."""

    def rhs(w_list):
        wf = fill_halos(w_list, metrics_list, topo, ref, winf)
        rsv = cfg.row_scale(w_list[0].dtype, w_list[0].device)
        out = []
        for i, (w, m) in enumerate(zip(wf, metrics_list)):
            ex = extras_list[i] if extras_list else None
            r = block_residual(w, m, cfg, ref, ex, por=topo.blocks[i].por)
            if rsv is not None:
                r = r / rsv    # the physical residual for explicit marching
            out.append(-r / m.vol[2:-2, 2:-2, 2:-2][..., None])
        return out

    def add(ws, ks, fac):
        return [_with_interior(w, w[2:-2, 2:-2, 2:-2] + fac * k)
                for w, k in zip(ws, ks)]

    def step(w_list):
        k1 = rhs(w_list)
        k2 = rhs(add(w_list, k1, 0.5 * dt))
        k3 = rhs(add(w_list, k2, 0.5 * dt))
        k4 = rhs(add(w_list, k3, dt))
        new = w_list
        for k, fac in ((k1, dt / 6), (k2, dt / 3), (k3, dt / 3),
                       (k4, dt / 6)):
            new = add(new, k, fac)
        return new, residual_norms(k1)[0]

    inner_res = []
    times = []
    failed = False
    for n in range(n_steps):
        w_list, nm = step(w_list)
        rfin = float(nm)
        inner_res.append(rfin)
        times.append((n + 1) * dt)
        if not np.isfinite(rfin):
            failed = True
            break
        if callback:
            callback(n, (n + 1) * dt, w_list)
    return w_list, UnsteadyInfo(
        n_steps=len(times), times=np.asarray(times),
        inner_res=np.asarray(inner_res), failed=failed)
