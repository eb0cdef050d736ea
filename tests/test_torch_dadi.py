"""Port parity for the DADI smoother and its scalar operator
(solvers/smoothers.py, solvers/dadi.py), in float64 on the CPU, at the
seeded perturbed free stream of tests/torch_pairs.py:

- ``residual_averaging`` against the JAX package's to 1e-13;
- the scalar ``build_dadi_data`` and ``dadi_apply`` to 1e-12 (public
  functions of the module that nothing in either package calls), on the
  Euler and the RANS-SA wing (slow);
- one ``dadi_iteration`` (the three-axis line-PC update the DADI smoother
  runs) on the Euler and the RANS-SA wing (slow), states and residuals to
  1e-10;
- ``solve_rk`` with ``smoother: "DADI"`` through ``ADFLOW``, a few
  iterations of the Euler wing: the history to 1e-9.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adflow_torch.solvers import dadi, smoothers
from adflow_tpu.solvers import dadi as jdadi
from adflow_tpu.solvers import smoothers as jsmoothers
from tests.torch_pairs import rel, variant_pair

TOL = 1e-12


@pytest.fixture(scope="module")
def euler():
    return variant_pair("euler_wing")


@pytest.fixture(scope="module")
def rans():
    return variant_pair("rans_wing")


@pytest.mark.parametrize("shape,eps", [((16, 8, 8, 5), 0.5),
                                       ((6, 2, 5, 6), 0.25)])
def test_residual_averaging_matches_jax(shape, eps):
    r = np.random.default_rng(1).standard_normal(shape)
    want = jsmoothers.residual_averaging(jnp.asarray(r), eps)
    got = smoothers.residual_averaging(torch.from_numpy(r), eps)
    assert rel(want, got.numpy()) < 1e-13
    # it smooths: the averaged residual is smaller than the input
    assert float(torch.abs(got).max()) < float(np.abs(r).max())


# the RANS-SA wing's pair costs 17 s to build (the JAX package's wall
# distance and compiles), so its cases are slow
BOTH = ["euler", pytest.param("rans", marks=pytest.mark.slow)]


@pytest.mark.parametrize("case", BOTH)
def test_dadi_data_and_apply_match_jax(case, request):
    pair = request.getfixturevalue(case)
    js, ts = pair.js, pair.ts
    wj, wt = pair.wj[0], pair.wt[0]
    dtinv = np.random.default_rng(2).uniform(
        1.0, 2.0, tuple(n - 4 for n in wt.shape[:3]))
    dj = jdadi.build_dadi_data(wj, js.metrics_list[0], js.cfg, js.ref,
                               jnp.asarray(dtinv), relax=0.9)
    dt = dadi.build_dadi_data(wt, ts.metrics_list[0], ts.cfg, ts.ref,
                              torch.from_numpy(dtinv), relax=0.9)
    for (lj, pj), (lt, pt) in zip(dj.lams, dt.lams):
        assert rel(lj, lt.numpy()) < TOL and rel(pj, pt.numpy()) < TOL
    v = np.random.default_rng(3).standard_normal(
        tuple(n - 4 for n in wt.shape[:3]) + (wt.shape[-1],))
    want = jdadi.dadi_apply(dj, jnp.asarray(v))
    got = dadi.dadi_apply(dt, torch.from_numpy(v))
    assert rel(want, got.numpy()) < TOL


@pytest.mark.parametrize("case", BOTH)
def test_dadi_iteration_matches_jax(case, request):
    pair = request.getfixturevalue(case)
    js, ts = pair.js, pair.ts
    cfl = 5.0
    nj, rj = jsmoothers.dadi_iteration(
        js.w_list, js.metrics_list, js.topo, js.cfg, js.ref, js.winf, cfl,
        js.extras_list)
    nt, rt = smoothers.dadi_iteration(
        ts.w_list, ts.metrics_list, ts.topo, ts.cfg, ts.ref, ts.winf, cfl,
        ts.extras_list)
    for a, b in zip(rj, rt):
        assert rel(a, b.numpy()) < 1e-10
    for a, b in zip(nj, nt):
        a, b = np.asarray(a)[2:-2, 2:-2, 2:-2], b[2:-2, 2:-2, 2:-2].numpy()
        for c in range(a.shape[-1]):
            assert rel(a[..., c], b[..., c]) < 1e-10, c
    # the update moved the state
    assert rel(np.asarray(js.w_list[0])[2:-2, 2:-2, 2:-2],
               nt[0][2:-2, 2:-2, 2:-2].numpy()) > 1e-6


def test_dadi_solve_matches_jax():
    """``ADFLOW`` with the DADI smoother, 25 iterations (one chunk) of the
    Euler wing from the perturbed free stream."""
    from tests.torch_pairs import solvers, perturbed

    opts = dict(smoother="DADI", useANKSolver=False, useNKSolver=False,
                nCycles=25, CFL=5.0)
    js, ts = solvers("euler_wing", **opts)
    w0 = perturbed(np.asarray(js.getStates()), 5)
    js.setStates(w0)
    ts.setStates(w0)
    js(js.curAP)
    ts(ts.curAP)
    hj, ht = js.solve_info.history, ts.solve_info.history
    assert hj.shape == ht.shape == (25, 2)
    assert np.all(np.isfinite(ht)) and ht[-1, 0] < ht[0, 0]
    assert rel(hj[:, 0], ht[:, 0]) < 1e-9
    assert rel(np.asarray(js.getStates()), ts.getStates().numpy()) < 1e-9
