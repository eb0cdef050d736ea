"""Port parity for the time-spectral method (solvers/timespectral.py and
ADFLOW's 'time spectral' branch), in float64 on the CPU:

- ``spectral_deriv_matrix`` equal to the JAX package's and exact on the
  harmonics at the collocation points (tests/test_time_spectral.py): 1e-12;
- ``instance_refstates``: each instance's alpha, free stream and
  directions equal to the JAX package's;
- one pseudo-time cycle of 3 pitching instances of the 16x8x8 Euler wing,
  from the seeded perturbed free stream: the instances' states and the
  norm to 1e-10;
- ``stability_derivatives`` against the JAX package's to 1e-12, and exact
  on a manufactured fit;
- slow: ``equationMode: "time spectral"`` through ``ADFLOW`` with
  ``alphaAmplitude`` (25 cycles, one chunk): the history, and cl0,
  clalpha and clalphadot from ``evalFunctions``, to 1e-9.
"""

import jax
import numpy as np
import pytest
import torch

from adflow_torch.core.refstate import AeroProblem
from adflow_torch.solvers import timespectral as ts_mod
from adflow_tpu.core.refstate import AeroProblem as JaxAP
from adflow_tpu.solvers import timespectral as jts
from tests.torch_pairs import perturbed, rel, solvers

OMEGA = 2.0 * np.pi
TS_OPTS = {"equationMode": "time spectral", "timeIntervals": 3,
           "omegaFourier": OMEGA, "useANKSolver": False,
           "useNKSolver": False, "CFL": 1.2}


@pytest.mark.parametrize("n", [3, 4, 5, 8])
def test_spectral_matrix_matches_jax(n):
    period = 2.0
    D = ts_mod.spectral_deriv_matrix(n, period)
    np.testing.assert_allclose(D, jts.spectral_deriv_matrix(n, period),
                               rtol=0, atol=1e-12)
    t = np.arange(n) * period / n
    om = 2 * np.pi / period
    np.testing.assert_allclose(D @ np.sin(om * t), om * np.cos(om * t),
                               atol=1e-12)
    np.testing.assert_allclose(D @ np.ones(n), 0.0, atol=1e-12)


def test_instance_refstates_match_jax():
    kw = dict(name="p", mach=0.6, alpha=1.5, beta=0.5, reynolds=2e6,
              T=280.0, chordRef=0.8)
    rt, pt = ts_mod.instance_refstates(AeroProblem(**kw), 3, OMEGA, 1.0, 2,
                                       1)
    rj, pj = jts.instance_refstates(JaxAP(**kw), 3, OMEGA, 1.0, 2, 1)
    assert pt == pj == 1.0
    for a, b in zip(rj, rt):
        assert a.alpha == b.alpha
        np.testing.assert_allclose(b.winf(), a.winf(), rtol=1e-15)
        for f in ("u_inf", "vel_dir", "lift_dir", "drag_dir"):
            np.testing.assert_allclose(np.asarray(getattr(b, f)),
                                       np.asarray(getattr(a, f)),
                                       rtol=1e-15, atol=1e-15)
        assert a.mu_inf == b.mu_inf
    assert len({r.alpha for r in rt}) == 3


def test_time_spectral_cycle_matches_jax():
    """One coupled cycle of 3 instances pitched by 1 degree, the JAX side
    op by op (its compile of the cycle takes longer)."""
    js, ts = solvers("euler_wing", **TS_OPTS)
    rj, period = jts.instance_refstates(js.curAP, 3, OMEGA, 1.0, 2, 0)
    rt, _ = ts_mod.instance_refstates(ts.curAP, 3, OMEGA, 1.0, 2, 0)
    w0 = [perturbed(np.asarray(js.getStates()), 5, seed=q)
          for q in range(3)]
    wj, wt = [], []
    for q in range(3):
        js.setStates(w0[q])
        ts.setStates(w0[q])
        wj.append(list(js.w_list))
        wt.append(list(ts.w_list))
    winfs_j = [jax.numpy.asarray(r.winf()) for r in rj]
    winfs_t = [torch.tensor(r.winf()) for r in rt]
    kw = dict(cfl=1.2, n_cycles=1, chunk=1)
    with jax.disable_jit():
        oj, ij = jts.solve_time_spectral(wj, js.metrics_list, js.topo,
                                         js.cfg, rj, winfs_j, period, **kw)
    ot, it = ts_mod.solve_time_spectral(wt, ts.metrics_list, ts.topo,
                                        ts.cfg, rt, winfs_t, period, **kw)
    assert it.iterations == 1 and it.history.shape == (1, 2)
    assert rel(ij.history, it.history) < 1e-10
    for q in range(3):
        a = np.asarray(oj[q][0])[2:-2, 2:-2, 2:-2]
        b = ot[q][0][2:-2, 2:-2, 2:-2].numpy()
        assert rel(a, b) < 1e-10, q
        assert rel(w0[q].reshape(b.shape), b) > 1e-6


def test_stability_derivatives_match_jax():
    n, omega, mach, chord = 5, 3.0, 0.6, 0.9
    period = 2 * np.pi / omega
    rng = np.random.default_rng(9)
    coeffs = {k: rng.standard_normal(n) for k in ("cl", "cd", "cmz")}
    alphas = 2.0 + 0.7 * np.sin(omega * np.arange(n) * period / n)
    want = jts.stability_derivatives(coeffs, alphas, omega, period, mach,
                                     chord)
    got = ts_mod.stability_derivatives(coeffs, alphas, omega, period, mach,
                                       chord)
    assert set(got) == set(want) and len(got) == 9
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-12 * max(abs(want[k]), 1.0), k

    # a manufactured fit is recovered exactly
    n = 8
    t = np.arange(n) * period / n
    alpha0, amp = np.radians(1.0), np.radians(0.5)
    k = omega * chord / (2 * mach)
    cla, clad, cl0 = 5.5, -1.2, 0.11
    cl = (cl0 + cla * (alpha0 + amp * np.sin(omega * t))
          + clad * k * amp * np.cos(omega * t))
    out = ts_mod.stability_derivatives(
        {"cl": cl}, np.degrees(alpha0 + amp * np.sin(omega * t)), omega,
        period, mach, chord)
    np.testing.assert_allclose(out["clalpha"], cla, rtol=1e-10)
    np.testing.assert_allclose(out["clalphadot"], clad, rtol=1e-10)
    np.testing.assert_allclose(out["cl0"], cl0, rtol=1e-8)


@pytest.mark.slow
def test_time_spectral_solve_matches_jax():
    """25 cycles (one chunk) through ``ADFLOW`` with ``alphaAmplitude``;
    ``evalFunctions`` merges the stability derivatives. Slow: the JAX
    package compiles the chunk."""
    js, ts = solvers("euler_wing", nCycles=25, **TS_OPTS)
    names = ["cl", "cl0", "clalpha", "clalphadot", "cd0", "cmzalpha"]
    js(js.curAP, alphaAmplitude=1.0)
    ts(ts.curAP, alphaAmplitude=1.0)
    assert rel(js.solve_info.history, ts.solve_info.history) < 1e-9
    assert len(ts.ts_states) == 3 and len(ts.ts_refs) == 3
    assert ts.w_list is ts.ts_states[0]
    fj = js.evalFunctions(js.curAP, {}, names)
    ft = ts.evalFunctions(ts.curAP, {}, names)
    assert set(ft) == set(fj) == {f"w_{n}" for n in names}
    for k in fj:
        assert np.isfinite(ft[k])
        assert abs(fj[k] - ft[k]) <= 1e-9 * abs(fj[k]), k
