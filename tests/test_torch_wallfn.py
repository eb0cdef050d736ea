"""Port parity for the wall functions (physics/bc.py: ``spalding_utau``
and the wall-function ghost state of the adiabatic no-slip wall, with the
SA wall anchor), in float64 on the CPU:

- ``spalding_utau`` against the JAX package's, to 1e-12, at the two
  limits that tests/test_wallfunctions.py:43-60 checks (where the port is
  held to them as well) and at seeded random inputs; its jvp and vjp to
  1e-10;
- ``fill_halos`` of the 16x12 RANS plate with ``useWallFunctions``, for SA
  and for SST, at the seeded perturbed free stream with one wall cell
  whose tangential velocity is exactly zero, to 1e-13 of the largest
  entry; at that cell the port's derivatives of the fill are finite
  (the jvp of ``jnp.linalg.norm`` at a zero vector is NaN, that of
  ``torch.linalg.norm`` 0);
- slow: the residual's jvp and vjp through the wall-function ghosts (the
  JAX package's compile of 30 unrolled Newton iterations a ghost layer
  takes 90 s on one CPU worker), to 1e-10.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import adflow_tpu.physics.sst  # noqa: F401  (before any jax.jit)
from adflow_torch.physics import bc as tbc
from adflow_torch.physics.residual import fill_halos
from adflow_tpu.physics import bc as jbc
from tests.torch_pairs import check_flat_derivatives, rel, variant_pair

TOL = 1e-12
FILL_TOL = 1e-13
DERIV_TOL = 1e-10
NU = 1e-5
UT_STAR, YP = 0.05, 100.0
LIMITS = {
    # the viscous sublayer, y+ ~ 0.5: u_tau -> sqrt(nu u / d)
    "resolved": (0.5, 1e-5, np.sqrt(NU * 0.5 / 1e-5)),
    # the log layer at y+ = 100: u from the log law at u_tau*
    "log layer": (UT_STAR * (np.log(YP) / tbc.KARMAN_WF + tbc.B_WF),
                  YP * NU / UT_STAR, UT_STAR),
}


def _random_inputs():
    rng = np.random.default_rng(4)
    umag = 10.0 ** rng.uniform(-3, 0, 64)
    d1 = 10.0 ** rng.uniform(-6, -2, 64)
    nu = 10.0 ** rng.uniform(-7, -4, 64)
    return umag, d1, nu


@pytest.mark.parametrize("case", ["resolved", "log layer", "random"])
def test_spalding_utau_matches_jax(case):
    if case == "random":
        args = _random_inputs()
    else:
        u, d1, want_ut = LIMITS[case]
        args = (np.array([u]), np.array([d1]), np.array([NU]))
    want = np.asarray(jbc.spalding_utau(*(jnp.asarray(a) for a in args)))
    got = tbc.spalding_utau(*(torch.from_numpy(a) for a in args)).numpy()
    assert rel(want, got) < TOL
    if case != "random":
        assert abs(got[0] / want_ut - 1.0) < 0.05


def test_spalding_utau_derivatives_match_jax():
    args = _random_inputs()
    rng = np.random.default_rng(5)
    dirs = [rng.standard_normal(64) * a for a in args]
    cot = rng.standard_normal(64)
    jv_j, vj_j = jax.jit(lambda a, d, c: (
        jax.jvp(jbc.spalding_utau, a, d)[1],
        jax.vjp(jbc.spalding_utau, *a)[1](c)))(
        tuple(jnp.asarray(a) for a in args),
        tuple(jnp.asarray(d) for d in dirs), jnp.asarray(cot))
    targs = tuple(torch.from_numpy(a) for a in args)
    jv_t = torch.func.jvp(tbc.spalding_utau, targs,
                          tuple(torch.from_numpy(d) for d in dirs))[1]
    vj_t = torch.func.vjp(tbc.spalding_utau, *targs)[1](
        torch.from_numpy(cot))
    assert rel(jv_j, jv_t.numpy()) < DERIV_TOL
    for a, b in zip(vj_j, vj_t):
        assert rel(a, b.numpy()) < DERIV_TOL


def _zero_tangential(pair):
    """The pair's state with the two wall cells of one column (i = 10,
    k = 0, under the plate) moving normal to the wall only: their x and z
    momenta zero, so the tangential velocity the ghost sees is exactly 0
    (the plate's wall normal is exactly +-y)."""
    ts = pair.ts
    nw = ts.ref.nw
    w = pair.w0.reshape(ts.mesh.blocks[0].dims + (nw,)).copy()
    w[10, 0:2, 0, 1] = 0.0
    w[10, 0:2, 0, 3] = 0.0
    w = w.reshape(-1)
    pair.js.setStates(w)
    ts.setStates(w)
    return w


@pytest.fixture(scope="module", params=["SA", "SST"])
def plate(request):
    pair = variant_pair("rans_plate", turbulenceModel=request.param,
                        useWallFunctions=True)
    _zero_tangential(pair)
    return pair


def test_ghost_fill_matches_jax(plate):
    js, ts = plate.js, plate.ts
    assert ts.ref.wall_fn and js.ref.wall_fn
    want = np.asarray(js._filled_w()[0])
    got = ts._filled_w()[0].numpy()
    assert np.all(np.isfinite(got))
    assert np.abs(want - got).max() <= FILL_TOL * np.abs(want).max()
    # the wall-function ghosts differ from the no-slip mirror
    plain = fill_halos(ts.w_list, ts.metrics_list, ts.topo,
                       dataclasses.replace(ts.ref, wall_fn=False),
                       ts.winf)[0].numpy()
    assert np.abs(plain - got).max() > 1e-6 * np.abs(got).max()


def test_fill_derivatives_finite_at_zero_tangential_velocity(plate):
    ts = plate.ts
    w = ts.w_list[0]
    rng = np.random.default_rng(6)
    v = torch.from_numpy(rng.standard_normal(w.shape))

    def fill(a):
        return fill_halos([a], ts.metrics_list, ts.topo, ts.ref, ts.winf)[0]

    jv = torch.func.jvp(fill, (w,), (v,))[1]
    vj = torch.func.vjp(fill, w)[1](v)[0]
    assert bool(torch.isfinite(jv).all() and torch.isfinite(vj).all())
    # the ghosts of the zero-tangential cell do move with the state
    assert float(jv[12, 0:2, 2].abs().max()) > 0.0


@pytest.mark.slow
def test_residual_derivatives_match_jax():
    pair = variant_pair("rans_plate", useWallFunctions=True)
    check_flat_derivatives(pair, tol=DERIV_TOL)
