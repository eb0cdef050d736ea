"""Time-spectral method: N coupled time instances of a periodic flow
(counterpart of adflow_tpu/solvers/timespectral.py).

Reference analogues:
- the spectral coupling terms entering the residual through
  ``initres_block`` (src/solver/residuals.F90:427), with the time-spectral
  matrices of src/initFlow and modules/inputTimeSpectral (options
  ``timeIntervals``, ``omegaFourier``, ``alphaMode``; inputParam.F90:639);
- the regression test tests/reg_tests/test_time_spectral_naca64A010.py
  (a pitching airfoil, alphaMode).

The N instances are solved as one coupled steady problem: each instance's
spatial residual with its own reference state (the residual kernels launch
once per instance and block where they apply), plus the dense N x N
spectral derivative applied across the instances. Pseudo-time RK marches
all instances together; the norms stay on the device within a chunk of
iterations and are copied to the host once a chunk.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from adflow_torch.core.refstate import AeroProblem, make_reference_state
from adflow_torch.physics.residual import (
    MeshTopology, ProblemConfig, block_residual, fill_halos)
from adflow_torch.physics.thermo import pressure
from adflow_torch.physics.timestep import local_timestep
from adflow_torch.solvers.smoothers import (
    RK_COEFFS, _with_interior, residual_norms)


class TSInfo(NamedTuple):
    converged: bool
    failed: bool
    iterations: int
    total_r0: float
    total_r_final: float
    history: np.ndarray


def spectral_deriv_matrix(n: int, period: float) -> np.ndarray:
    """The standard time-spectral differentiation matrix D (n x n):
    (dw/dt)_q = sum_r D[q, r] w_r for n equally spaced instances."""
    D = np.zeros((n, n))
    for q in range(n):
        for r in range(n):
            m = q - r
            if m == 0:
                continue
            if n % 2 == 0:
                D[q, r] = 0.5 * (-1.0) ** m / np.tan(np.pi * m / n)
            else:
                D[q, r] = 0.5 * (-1.0) ** m / np.sin(np.pi * m / n)
    return D * (2.0 * np.pi / period)


def instance_refstates(ap: AeroProblem, n: int, omega: float,
                       alpha_amplitude: float, lift_index: int,
                       n_turb: int):
    """Per-instance reference states for alphaMode pitching:
    alpha_q = alpha + amp sin(omega t_q) (inputTSStabDeriv alphaMode).
    Each instance's problem takes mach, alpha, beta, the Reynolds number
    and length, the reference values and T from ``ap``, as in the JAX
    package."""
    period = 2.0 * np.pi / omega if omega > 0 else 1.0
    refs = []
    for q in range(n):
        t_q = q * period / n
        ap_q = AeroProblem(
            name=f"{ap.name}_ts{q}", mach=ap.mach,
            alpha=ap.alpha + alpha_amplitude * np.sin(omega * t_q),
            beta=ap.beta, reynolds=ap.reynolds,
            reynoldsLength=ap.reynoldsLength, areaRef=ap.areaRef,
            chordRef=ap.chordRef, xRef=ap.xRef, yRef=ap.yRef, zRef=ap.zRef,
            T=ap.T)
        refs.append(make_reference_state(ap_q, lift_index=lift_index,
                                         n_turb=n_turb))
    return refs, period


def solve_time_spectral(w_inst, metrics_list, topo: MeshTopology,
                        cfg: ProblemConfig, refs, winfs, period: float,
                        extras_list=None, cfl: float = 1.5,
                        n_cycles: int = 2000, l2_conv: float = 1e-8,
                        chunk: int = 25, monitor=None):
    """Pseudo-time RK on the coupled spectral system.

    w_inst: a list over instances of per-block state lists.
    Returns (w_inst, TSInfo). The spectral term of instance q is
    V sum_r D[q, r] w_r (the BDF analogue of initres_block)."""
    n = len(w_inst)
    D_np = spectral_deriv_matrix(n, period)
    D = D_np.tolist()
    n_blocks = len(metrics_list)

    def ts_residual(w_inst):
        r_inst = []
        for q in range(n):
            wq = fill_halos(w_inst[q], metrics_list, topo, refs[q],
                            winfs[q])
            r_inst.append([
                block_residual(wq[i], metrics_list[i], cfg, refs[q],
                               extras_list[i] if extras_list else None,
                               por=topo.blocks[i].por)
                for i in range(n_blocks)])
        # the spectral coupling, per block, summed over the instances
        rsv = cfg.row_scale(w_inst[0][0].dtype, w_inst[0][0].device)
        out = []
        for q in range(n):
            rq = []
            for i in range(n_blocks):
                vol = metrics_list[i].vol[2:-2, 2:-2, 2:-2][..., None]
                acc = sum(D[q][r] * w_inst[r][i][2:-2, 2:-2, 2:-2]
                          for r in range(n))
                acc = acc[..., :r_inst[q][i].shape[-1]]
                if rsv is not None:
                    # match block_residual's turbResScale rows, so the
                    # spectral system is an exact row scaling
                    acc = acc * rsv
                rq.append(r_inst[q][i] + vol * acc)
            out.append(rq)
        return out

    # the spectral term's share of the pseudo-time stability limit: the
    # V D coupling adds eigenvalues ~ V sum_r |D[q, r]| that the convective
    # CFL does not see (the reference adds the time-spectral radius inside
    # timeStep, solverUtils.F90); without it instance differences grow
    s_abs_d = float(np.abs(D_np).sum(axis=1).max())

    def one(w_inst):
        dts = []
        w0 = []
        for q in range(n):
            wq = fill_halos(w_inst[q], metrics_list, topo, refs[q],
                            winfs[q])
            w0.append(wq)
            dq = []
            for i in range(n_blocks):
                vol = metrics_list[i].vol[2:-2, 2:-2, 2:-2]
                dt = local_timestep(wq[i], pressure(wq[i]), metrics_list[i],
                                    cfl, cfg, refs[q])
                # dtau/V = 1 / (V/dt_conv + V sum|D| / cfl)
                dq.append(1.0 / (vol / dt + vol * s_abs_d / cfl))
            dts.append(dq)
        wk = w0
        r_first = None
        rsv = cfg.row_scale(w0[0][0].dtype, w0[0][0].device)
        for alpha in RK_COEFFS:
            r = ts_residual(wk)
            if r_first is None:
                r_first = r
            if rsv is not None:
                # the explicit update marches the physical residual
                r = [[rb * (1.0 / rsv) for rb in rq] for rq in r]
            wk = [fill_halos(
                [_with_interior(w0[q][i], w0[q][i][2:-2, 2:-2, 2:-2]
                                - alpha * dts[q][i][..., None] * r[q][i])
                 for i in range(n_blocks)],
                metrics_list, topo, refs[q], winfs[q]) for q in range(n)]
        return wk, residual_norms([rb for rq in r_first for rb in rq])[0]

    hist_all = []
    it = 0
    r0 = None
    failed = converged = False
    while it < n_cycles:
        rows = []
        for _ in range(chunk):
            w_inst, nm = one(w_inst)
            rows.append(nm)
        hist = torch.stack(rows).double().cpu().numpy()
        hist_all.append(hist)
        it += len(hist)
        if r0 is None:
            r0 = float(hist[0])
        rnow = float(hist[-1])
        if monitor:
            monitor(it, rnow, 0.0)
        if not np.isfinite(rnow):
            failed = True
            break
        if rnow <= l2_conv * r0:
            converged = True
            break
    h = np.concatenate(hist_all) if hist_all else np.zeros((0,))
    return w_inst, TSInfo(
        converged=converged, failed=failed, iterations=it,
        total_r0=float(r0 or 0.0),
        total_r_final=float(h[-1]) if len(h) else float("nan"),
        history=np.stack([h, np.zeros_like(h)], axis=-1))


def stability_derivatives(coeff_inst: dict, alphas_deg, omega: float,
                          period: float, mach: float,
                          chord_ref: float = 1.0) -> dict:
    """Time-spectral stability derivatives from per-instance coefficients
    (reference: inputTSStabDeriv TSAlphaMode post-processing, the
    cl0/clalpha/clalphadot... cost functions, constants.F90:370-384).

    For alpha(t) = alpha0 + A sin(omega t) each coefficient is fit by
    least squares to  c(t) = c_mean + a sin(omega t) + b cos(omega t):
      c_alpha    = a / A                      (per radian)
      c_alphadot = b / (A k),  k = omega chord / (2 V)   (reduced frequency;
                   V = Mach in the solver's a_inf-based time)
      c_0        = c_mean - c_alpha alpha0    (linear extrapolation)

    coeff_inst: {name: n per-instance values}; alphas_deg: per-instance
    alpha in degrees. Returns {'<name>0', '<name>alpha', '<name>alphadot'}
    for each name. Host (numpy) work.
    """
    n = len(alphas_deg)
    a_rad = np.radians(np.asarray(alphas_deg, float))
    alpha0 = float(a_rad.mean())
    amp = float(np.max(np.abs(a_rad - alpha0)))
    t = np.arange(n) * period / n
    X = np.stack([np.ones(n), np.sin(omega * t), np.cos(omega * t)],
                 axis=1)
    k = omega * chord_ref / (2.0 * max(mach, 1e-12))
    out = {}
    for nm, vals in coeff_inst.items():
        cmean, a, b = np.linalg.lstsq(X, np.asarray(vals, float),
                                      rcond=None)[0]
        c_alpha = a / max(amp, 1e-30)
        out[f"{nm}0"] = cmean - c_alpha * alpha0
        out[f"{nm}alpha"] = c_alpha
        out[f"{nm}alphadot"] = b / (max(amp, 1e-30) * max(k, 1e-30))
    return out
