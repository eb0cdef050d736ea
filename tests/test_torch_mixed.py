"""Port parity for ``precision='mixed'``: the f32 phases of the Newton
driver, then its f64 continuation (solvers/newton.py), on the CPU.

- The mixed data: both packages' f64 metrics (recomputed from the node
  coordinates, not upcast) and free stream, and the RANS plate's f64 wall
  distance, to 1e-14;
- slow: the f64 continuation handed the same f32 state: both packages'
  ``solve_newton_driver`` in float64 from the Euler wing's seeded
  perturbed state rounded to f32, two ANK steps and one NK step: the
  residual history and the final states to 1e-10;
- slow too: a whole ``precision='mixed'`` solve of the Euler wing with NK on,
  in both packages: the f32 ANK phase hands over at the same step and the
  final states agree to 1e-8 after converging to 1e-10 of the free-stream
  residual.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adflow_torch.solvers import newton
from adflow_tpu.solvers import newton as jax_newton
from tests.torch_pairs import perturbed, rel, solvers

MIXED = {"precision": "mixed", "useNKSolver": True}
TOL = 1e-10
# the continuation: ANK below NKSwitchTol hands over to NK after two steps
CONTINUATION = {"nCycles": 3, "NKSwitchTol": 0.7}


@pytest.mark.parametrize("case", [
    "euler_wing", pytest.param("rans_plate", marks=pytest.mark.slow)])
def test_mixed_data_match_jax(case):
    """The RANS plate's case is slow: the JAX package's wall distance and
    set-up take most of the 26 s the two cases took together on one CPU
    worker."""
    js, ts = solvers(case, **MIXED)
    assert ts.dtype == torch.float32
    mj, winf_j, ej = js._mixed_data()
    mt, winf_t, et = ts._mixed_data()
    assert ts._mixed_data()[0] is mt      # cached
    assert winf_t.dtype == torch.float64
    assert rel(winf_j, winf_t.numpy()) < 1e-15
    for a, b in zip(mj, mt):
        for f in ("siE", "sjE", "skE", "vol", "xc_ext"):
            assert getattr(b, f).dtype == torch.float64
            assert rel(getattr(a, f), getattr(b, f).numpy()) < 1e-14
    assert (ej is None) == (et is None) == (case == "euler_wing")
    if et is not None:
        assert rel(ej[0]["walldist"], et[0]["walldist"].numpy()) < 1e-14


@pytest.mark.slow
def test_f64_continuation_matches_jax():
    """Slow: the JAX package compiles its f64 ANK and NK steps, about 60 s
    on one CPU worker."""
    js, ts = solvers("euler_wing", **MIXED)
    w32 = perturbed(np.asarray(js.getStates()), 5).astype(np.float32)
    js.setStates(w32)
    ts.setStates(w32)
    opts_j = js.options.replace(**CONTINUATION)
    opts_t = ts.options.replace(**CONTINUATION)
    mj, winf_j, _ = js._mixed_data()
    mt, winf_t, _ = ts._mixed_data()
    wj, info_j = jax_newton.solve_newton_driver(
        [jnp.asarray(w, jnp.float64) for w in js.w_list], mj, js.topo,
        js.cfg, js.ref, winf_j, opts_j)
    wt, info_t = newton.solve_newton_driver(
        [w.to(torch.float64) for w in ts.w_list], mt, ts.topo, ts.cfg,
        ts.ref, winf_t, opts_t)
    assert [r.kind for r in info_t.steps] == ["ANK", "ANK", "NK"]
    assert all(r.dtype == torch.float64 for r in info_t.steps)
    assert info_j.history.shape == info_t.history.shape == (3, 2)
    assert rel(info_j.history, info_t.history) < TOL
    assert [r.stats[1] for r in info_t.steps] == list(info_t.history[:, 0])
    assert rel(np.asarray(wj[0]), wt[0].numpy()) < TOL


@pytest.mark.slow
def test_mixed_solve_matches_jax():
    """Slow: the JAX package compiles its f32 ANK step and its f64 ANK and
    NK steps."""
    opts = dict(MIXED, nCycles=60, L2Convergence=1e-10)
    js, ts = solvers("euler_wing", **opts)
    w0 = perturbed(np.asarray(js.getStates()), 5)
    for s in (js, ts):
        s.setStates(w0)
        s(s.curAP)
    info_j, info_t = js.solve_info, ts.solve_info
    assert info_t.converged and info_j.converged and not info_t.failed
    dtypes = [r.dtype for r in info_t.steps]
    hand = dtypes.index(torch.float64)
    assert hand > 1 and set(dtypes[:hand]) == {torch.float32}
    # the f32 phase hands over at its first residual below 1e-2 of the
    # free-stream one: the same accepted step in both packages, and the
    # f64 continuation starts from that state
    first = [int(np.argmax(i.history[:, 0] <= 1e-2 * i.total_r0))
             for i in (info_t, info_j)]
    assert first[0] == first[1] > 0
    assert rel(info_j.history[:first[0] + 1],
               info_t.history[:first[0] + 1]) < 1e-3
    r_hand = info_t.history[first[0], 0]
    assert abs(info_t.steps[hand].stats[0] - r_hand) < 1e-2 * r_hand
    assert info_t.iterations == info_j.iterations
    assert rel(np.asarray(js.getStates()), ts.getStates().numpy()) < 1e-8


@pytest.mark.slow
def test_mixed_rans_solve_matches_jax():
    """Slow (about 350 s on one CPU worker): a whole ``precision='mixed'``
    NK solve of the RANS-SA plate that chip_smoke.py [19] converges on the
    card (16x12, Re 1e4), from the free stream in both packages, to 1e-10
    of the free-stream residual. The f32 phase (K1's plain version here)
    hands over at the same step in both, and the answers agree to f32
    rounding: both packages pack the f64 continuation's state back to f32
    (an ulp of the largest entry is 1.2e-7 of it) and evaluate the
    functions in f32."""
    opts = dict(MIXED, nCycles=60, L2Convergence=1e-10)
    js, ts = solvers("rans_plate", {"reynolds": 1e4}, **opts)
    for s in (js, ts):
        s(s.curAP)
    info_j, info_t = js.solve_info, ts.solve_info
    assert info_t.converged and info_j.converged and not info_t.failed
    assert info_t.total_r_final < 1e-10 * info_t.total_r0
    dtypes = [r.dtype for r in info_t.steps]
    hand = dtypes.index(torch.float64)
    assert hand > 1 and set(dtypes[:hand]) == {torch.float32}
    first = [int(np.argmax(i.history[:, 0] <= 1e-2 * i.total_r0))
             for i in (info_t, info_j)]
    assert first[0] == first[1] == hand - 1
    assert info_t.iterations == info_j.iterations
    names = ["cd", "mdot", "mavgptot", "mavgttot", "mavgps", "mavgmn",
             "aavgptot", "aavgps", "area"]
    fj = js.evalFunctions(js.curAP, {}, names)
    ft = ts.evalFunctions(ts.curAP, {}, names)
    assert fj.keys() == ft.keys() and len(ft) == len(names)
    for key in fj:
        assert abs(ft[key] - fj[key]) <= 1e-6 * abs(fj[key]), key
    assert rel(np.asarray(js.getStates()), ts.getStates().numpy()) < 2.5e-7
