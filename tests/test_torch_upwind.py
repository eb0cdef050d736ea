"""Port parity for the upwind and matrix-dissipation residuals
(physics/upwind.py) in float64 on the CPU.

Both packages take the 16x8x8 Euler wing of tests/torch_pairs.py at the
same seeded perturbed free stream:
- ``block_residual`` of the filled state, for ``upwind_residual`` with the
  Roe and van Leer fluxes and each of the four limiters, and for the
  central flux plus ``matrix_dissipation_residual``, to 1e-12 of the flux
  scale (the largest |p| times the largest face area);
- the jvp and vjp of the block residual from seeded directions, to 1e-10
  relative (Roe with van Albada, van Leer with no limiter, and matrix
  dissipation);
- free-stream preservation on the perturbed cube, below 1e-12;
- ``riemannSolver: 'ausmdv'`` raises in both packages.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adflow_torch.api.solver import ADFLOW
from adflow_torch.core.refstate import AeroProblem
from adflow_torch.meshgen.analytic import cube_mesh
from adflow_torch.physics import residual as torch_res
from adflow_tpu.physics import residual as jax_res
from tests.torch_pairs import newton_pair, rel

RES_TOL = 1e-12
DERIV_TOL = 1e-10
LIMITERS = ("van albada", "minmod", "no limiter", "first order")
# (discretization, riemannSolver, limiter)
VARIANTS = ([("upwind", rs, lim) for rs in ("roe", "van leer")
             for lim in LIMITERS]
            + [("central plus matrix dissipation", "roe", "van albada")])


@pytest.fixture(scope="module")
def wing():
    """The Euler wing pair at its seeded perturbed state, halos filled."""
    js, ts, jf, tf, w0 = newton_pair("euler_wing")
    wj = jax_res.fill_halos(jf.packer.unpack_into(jnp.asarray(w0),
                                                  js.w_list),
                            js.metrics_list, js.topo, js.ref, js.winf)
    wt = torch_res.fill_halos(tf.packer.unpack_into(torch.from_numpy(w0),
                                                    ts.w_list),
                              ts.metrics_list, ts.topo, ts.ref, ts.winf)
    return js, ts, w0, wj[0], wt[0]


def _cfgs(js, ts, disc, rs, lim):
    kw = dict(discretization=disc, riemann_solver=rs, limiter=lim)
    return (dataclasses.replace(js.cfg, **kw),
            dataclasses.replace(ts.cfg, **kw))


def _flux_scale(w, metrics):
    p = (0.4 * (w[..., 4] - 0.5 * np.sum(w[..., 1:4] ** 2, axis=-1)
                / w[..., 0]))
    smax = max(float(np.linalg.norm(np.asarray(s), axis=-1).max())
               for s in (metrics.si, metrics.sj, metrics.sk))
    return float(np.abs(p).max()) * smax


@pytest.mark.parametrize("disc,rs,lim", VARIANTS)
def test_residual_matches_jax(wing, disc, rs, lim):
    js, ts, _, wj, wt = wing
    cj, ct = _cfgs(js, ts, disc, rs, lim)
    want = np.asarray(jax_res.block_residual(
        wj, js.metrics_list[0], cj, js.ref, por=js.topo.blocks[0].por))
    got = torch_res.block_residual(wt, ts.metrics_list[0], ct, ts.ref,
                                   por=ts.topo.blocks[0].por).numpy()
    scale = _flux_scale(np.asarray(wj), js.metrics_list[0])
    assert want.shape == got.shape == (16, 8, 8, 5)
    # the discretization's own residual, not a vanishing one
    assert np.abs(want).max() > 1e-3 * scale
    assert np.abs(want - got).max() <= RES_TOL * scale


@pytest.mark.parametrize("disc,rs,lim", [
    pytest.param(*VARIANTS[0], marks=pytest.mark.slow), VARIANTS[6],
    pytest.param(*VARIANTS[-1], marks=pytest.mark.slow)])
def test_jvp_and_vjp_match_jax(wing, disc, rs, lim):
    """The block residual's jvp and vjp in the padded state from seeded
    directions (the halo fill's are held in tests/test_torch_bc_flow.py),
    the JAX side under one ``jax.jit``: its eager derivatives take 10-40 s
    a case. Roe with van Albada and matrix dissipation are slow (10-12 s
    each on one CPU worker, most of it the JAX package's compile); the
    matrix residual's vjp stays in the fast tier in
    tests/test_torch_matrix_pc.py. Not minmod: compiled, XLA's rounding flips its near-ties
    |a| < |b| and moves the JAX jvp past the tolerance, where the port
    agrees with the op-by-op JAX jvp (as at the JST sensor's kink,
    tests/torch_pairs.py)."""
    js, ts, _, wj, wt = wing
    cj, ct = _cfgs(js, ts, disc, rs, lim)
    por_j, por_t = js.topo.blocks[0].por, ts.topo.blocks[0].por
    rng = np.random.default_rng(3)
    v = rng.standard_normal(wt.shape) * np.abs(wt.numpy())
    u = rng.standard_normal(tuple(wt.shape[:3] - np.array(4)) + (5,))

    def fj(w):
        return jax_res.block_residual(w, js.metrics_list[0], cj, js.ref,
                                      por=por_j)

    def ft(w):
        return torch_res.block_residual(w, ts.metrics_list[0], ct, ts.ref,
                                        por=por_t)

    jv_j, vj_j = jax.jit(lambda w, d, c: (
        jax.jvp(fj, (w,), (d,))[1], jax.vjp(fj, w)[1](c)[0]))(
        wj, jnp.asarray(v), jnp.asarray(u))
    jv_t = torch.func.jvp(ft, (wt,), (torch.from_numpy(v),))[1]
    vj_t = torch.func.vjp(ft, wt)[1](torch.from_numpy(u))[0]
    assert rel(jv_j, jv_t.numpy()) < DERIV_TOL
    assert rel(vj_j, vj_t.numpy()) < DERIV_TOL


@pytest.mark.parametrize("disc,rs", [
    ("upwind", "Roe"), ("upwind", "van Leer"),
    ("central plus matrix dissipation", "Roe")])
def test_freestream_preserved_on_perturbed_cube(disc, rs):
    solver = ADFLOW(options={"equationType": "euler", "discretization": disc,
                             "riemannSolver": rs, "printIterations": False,
                             "printTiming": False},
                    mesh=cube_mesh(n=6, perturb=0.25), device="cpu")
    r = solver.getResidual(AeroProblem(name="fs", mach=0.5, alpha=2.0))
    assert max(float(torch.max(torch.abs(x))) for x in r) < 1e-12


def test_ausmdv_raises_as_in_jax(wing):
    js, ts, _, wj, wt = wing
    cj, ct = _cfgs(js, ts, "upwind", "ausmdv", "van albada")
    with pytest.raises(NotImplementedError, match="ausmdv"):
        jax_res.block_residual(wj, js.metrics_list[0], cj, js.ref,
                               por=js.topo.blocks[0].por)
    with pytest.raises(NotImplementedError, match="ausmdv"):
        torch_res.block_residual(wt, ts.metrics_list[0], ct, ts.ref,
                                 por=ts.topo.blocks[0].por)
