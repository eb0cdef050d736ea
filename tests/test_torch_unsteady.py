"""Port parity for the time-accurate solvers (solvers/unsteady.py and
ADFLOW's 'unsteady' branch), in float64 on the CPU:

- ``bdf_coefficients``;
- ``unsteady_residual_list``, BDF1 and BDF2, on the 16x12 RANS-SA plate
  with its turbulence rows (turbResScale on), at the seeded perturbed state with
  distinct history states: 1e-12 of the largest entry;
- one BDF2 dual-time step with 2 inner iterations (slow) and two explicit
  RK4 steps of the Euler pulse on ``cube_mesh(n=8)``
  (tests/test_unsteady.py): states and inner norms to 1e-10;
- ``equationMode: "unsteady"`` through ``ADFLOW``, BDF (50 inner
  iterations a step; slow) and explicit RK, ``nTimeSteps=2``:
  ``unsteady_info`` and the states to 1e-9.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adflow_torch.api.solver import ADFLOW
from adflow_torch.core.refstate import AeroProblem
from adflow_torch.meshgen.analytic import cube_mesh
from adflow_torch.solvers import unsteady
from adflow_tpu.api.solver import ADFLOW as JaxADFLOW
from adflow_tpu.core.refstate import AeroProblem as JaxAP
from adflow_tpu.meshgen.analytic import cube_mesh as jax_cube
from adflow_tpu.solvers import unsteady as junsteady
from tests.torch_pairs import rel, variant_pair

OPTS = {"equationType": "euler", "equationMode": "unsteady",
        "printIterations": False, "printTiming": False, "CFL": 2.0,
        "deltaT": 0.01}
PULSE = dict(name="pulse", mach=0.5, alpha=0.0)


def test_bdf_coefficients():
    for order in (1, 2):
        for first in (True, False):
            assert unsteady.bdf_coefficients(order, first) == \
                junsteady.bdf_coefficients(order, first)
    assert unsteady.bdf_coefficients(2, False) == (1.5, -2.0, 0.5)


def _histories(pair):
    """Two history states of the pair: its state scaled by 0.999 and
    1.002 (numpy for the JAX package, tensors for the port)."""
    wj = [np.asarray(w) for w in pair.js.w_list]
    return ([[w * 0.999 for w in wj], [w * 1.002 for w in wj]],
            [[torch.from_numpy(w * 0.999) for w in wj],
             [torch.from_numpy(w * 1.002) for w in wj]])


@pytest.fixture(scope="module")
def rans():
    return variant_pair("rans_plate")


@pytest.mark.parametrize("order", [1, 2])
def test_unsteady_residual_matches_jax(order, rans):
    pair = rans
    js, ts = pair.js, pair.ts
    (wn_j, wm_j), (wn_t, wm_t) = _histories(pair)
    coefs = unsteady.bdf_coefficients(order, False)
    want = junsteady.unsteady_residual_list(
        js.w_list, [jnp.asarray(w) for w in wn_j],
        [jnp.asarray(w) for w in wm_j], js.metrics_list, js.topo, js.cfg,
        js.ref, js.winf, 0.01, coefs, js.extras_list)
    got = unsteady.unsteady_residual_list(
        ts.w_list, wn_t, wm_t, ts.metrics_list, ts.topo, ts.cfg, ts.ref,
        ts.winf, 0.01, coefs, ts.extras_list)
    for a, b in zip(want, got):
        assert b.shape[-1] == 6
        for c in range(6):
            assert rel(np.asarray(a)[..., c], b[..., c].numpy()) < 1e-12, c


def _pulse_pair(**options):
    """Both packages' solvers on the 8^3 cube with the Gaussian density and
    energy pulse of tests/test_unsteady.py set."""
    opts = dict(OPTS, **options)
    js = JaxADFLOW(options=opts, mesh=jax_cube(n=8))
    js.setAeroProblem(JaxAP(**PULSE))
    ts = ADFLOW(options=opts, mesh=cube_mesh(n=8), device="cpu")
    ts.setAeroProblem(AeroProblem(**PULSE))
    x = np.asarray(js.x_list[0])
    xc = 0.125 * (x[:-1, :-1, :-1] + x[1:, :-1, :-1] + x[:-1, 1:, :-1]
                  + x[:-1, :-1, 1:] + x[1:, 1:, :-1] + x[1:, :-1, 1:]
                  + x[:-1, 1:, 1:] + x[1:, 1:, 1:])
    bump = 0.05 * np.exp(-np.sum((xc - 0.5) ** 2, axis=-1) / 0.02)
    wi = np.asarray(js.w_list[0])[2:-2, 2:-2, 2:-2].copy()
    wi[..., 0] *= 1.0 + bump
    wi[..., 4] *= 1.0 + bump
    js.setStates(wi.reshape(-1))
    ts.setStates(wi.reshape(-1))
    return js, ts


@pytest.mark.slow
def test_dual_time_step_matches_jax():
    """One BDF2 step (not the first: distinct w^n and w^{n-1}) with 2
    inner iterations; the JAX step op by op (its compile takes longer).
    Slow: 30 s, the JAX package's op-by-op compiles."""
    js, ts = _pulse_pair()
    wn_j = [w * 1.001 for w in js.w_list]
    wn_t = [w * 1.001 for w in ts.w_list]
    sj = junsteady.make_dual_time_step(js.metrics_list, js.topo, js.cfg,
                                       js.ref, js.winf, jnp.asarray(0.01),
                                       2, cfl=2.0, n_inner=2)
    st = unsteady.make_dual_time_step(ts.metrics_list, ts.topo, ts.cfg,
                                      ts.ref, ts.winf, 0.01, 2, cfl=2.0,
                                      n_inner=2)
    with jax.disable_jit():
        wj, hj = sj(js.w_list, wn_j, js.w_list, jnp.asarray(False))
    wt, ht = st(ts.w_list, wn_t, ts.w_list, False)
    assert ht.shape == (2,)
    assert rel(hj, ht.numpy()) < 1e-10
    assert rel(np.asarray(wj[0])[2:-2, 2:-2, 2:-2],
               wt[0][2:-2, 2:-2, 2:-2].numpy()) < 1e-10


def test_explicit_rk_steps_match_jax():
    js, ts = _pulse_pair()
    wj, ij = junsteady.solve_unsteady_explicit_rk(
        js.w_list, js.metrics_list, js.topo, js.cfg, js.ref, js.winf,
        n_steps=2, dt=0.005)
    wt, it = unsteady.solve_unsteady_explicit_rk(
        ts.w_list, ts.metrics_list, ts.topo, ts.cfg, ts.ref, ts.winf,
        n_steps=2, dt=0.005)
    assert it.n_steps == 2 and not it.failed
    assert rel(ij.inner_res, it.inner_res) < 1e-10
    np.testing.assert_array_equal(ij.times, it.times)
    assert rel(np.asarray(wj[0])[2:-2, 2:-2, 2:-2],
               wt[0][2:-2, 2:-2, 2:-2].numpy()) < 1e-10


@pytest.mark.parametrize("scheme", [
    pytest.param("BDF", marks=pytest.mark.slow), "explicit RK"])
def test_unsteady_solve_matches_jax(scheme):
    """Two physical steps. BDF's 50 inner iterations a step take its
    unsteady residual to round-off (1e-15 of the pulse's 1e-2), so the
    inner norms are held to 1e-9 of the pulse's steady residual norm.
    BDF is slow: the JAX package compiles its step (40 s)."""
    js, ts = _pulse_pair(timeIntegrationScheme=scheme)
    r_pulse = ts.getResNorms()[0]
    js(js.curAP, nTimeSteps=2)
    ts(ts.curAP, nTimeSteps=2)
    uj, ut = js.unsteady_info, ts.unsteady_info
    assert ut.n_steps == uj.n_steps == 2 and not ut.failed
    np.testing.assert_allclose(ut.times, uj.times, rtol=1e-15)
    assert np.all(np.isfinite(ut.inner_res))
    assert np.abs(uj.inner_res - ut.inner_res).max() < 1e-9 * r_pulse
    assert rel(np.asarray(js.getStates()), ts.getStates().numpy()) < 1e-9
    # the unsteady branch leaves solve_info unset, as in the JAX package
    assert ts.solve_info is None and js.solve_info is None
