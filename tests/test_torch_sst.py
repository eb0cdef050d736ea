"""Port parity for the SST k-omega model (physics/sst.py) in float64 on the
CPU, on the 16x8x8 viscous wing with RANS and ``turbulenceModel: 'SST'``
at the seeded perturbed free stream of tests/torch_pairs.py:

- ``sst_residual``, the SST ``eddy_viscosity`` and the whole 7-channel
  ``block_residual``, to 1e-12 of the flux scale (the eddy viscosity of
  its largest value);
- second-order advection of k and omega: the block residual to 1e-12,
  its jvp and vjp (slow) to 1e-10;
- the jvp and vjp of the whole residual (halo fill included), to 1e-10,
  from the perturbed state and, against the op-by-op JAX run, from the
  exact free stream, where the vorticity guard, F1's tanh(arg^4) and the
  production limiter sit at their kinks;
- free-stream preservation of the mean-flow rows on the perturbed cube,
  below 1e-12;
- the line PC's 7-equation apply, to 1e-10; slow: one coupled ANK step,
  its stats to 1e-10.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

# imported before any jax.jit: the module computes its closure constants
# with jnp at import, which inside a trace would leak tracers
import adflow_tpu.physics.sst as jsst  # noqa: F401
from adflow_torch.api.solver import ADFLOW
from adflow_torch.core.refstate import AeroProblem
from adflow_torch.meshgen.analytic import cube_mesh
from adflow_torch.physics import sst as tsst
from adflow_torch.physics.thermo import pressure as tpressure
from adflow_tpu.physics.thermo import pressure as jpressure
from tests.torch_pairs import (
    SHORT, block_residual_pair, check_ank_step, check_block_derivatives,
    check_flat_derivatives, check_pc_apply, flux_scale, rel, solvers,
    variant_pair)

RES_TOL = 1e-12
DERIV_TOL = 1e-10
SST = {"turbulenceModel": "SST"}


@pytest.fixture(scope="module")
def wing():
    return variant_pair("rans_wing", **SST)


@pytest.fixture(scope="module")
def parts(wing):
    """The SST residual, the SST eddy viscosity and the whole block
    residual of both packages at the filled state; the JAX side under one
    ``jax.jit`` (its op-by-op evaluation compiles each operation)."""
    from adflow_torch.physics import residual as tres
    from adflow_tpu.physics import residual as jres

    js, ts, wj, wt = wing.js, wing.ts, wing.wj, wing.wt
    mj, mt = js.metrics_list[0], ts.metrics_list[0]
    dj = js.extras_list[0]["walldist"]
    dt = ts.extras_list[0]["walldist"]
    por = js.topo.blocks[0].por

    @jax.jit
    def fj(w):
        p = jpressure(w)
        return (jsst.sst_residual(w, p, mj, js.cfg, js.ref, dj),
                jsst.eddy_viscosity(w, p, mj, js.ref, dj),
                jres.block_residual(w, mj, js.cfg, js.ref,
                                    js.extras_list[0], por=por))

    w0t = wt[0]
    p = tpressure(w0t)
    got = (tsst.sst_residual(w0t, p, mt, ts.cfg, ts.ref, dt),
           tsst.eddy_viscosity(w0t, p, mt, ts.ref, dt),
           tres.block_residual(w0t, mt, ts.cfg, ts.ref, ts.extras_list[0],
                               por=ts.topo.blocks[0].por))
    assert ts.cfg.n_turb == 2
    names = ("sst_residual", "eddy_viscosity", "block_residual")
    return {n: (np.asarray(a), np.asarray(b))
            for n, a, b in zip(names, fj(wj[0]), got)}


@pytest.mark.parametrize("part", ["sst_residual", "eddy_viscosity",
                                  "block_residual"])
def test_matches_jax(wing, parts, part):
    want, got = parts[part]
    scale = (float(np.abs(want).max()) if part == "eddy_viscosity"
             else flux_scale(wing.wj[0], wing.js.metrics_list[0]))
    assert want.shape == got.shape
    if part == "block_residual":
        assert want.shape == (16, 8, 8, 7)
    assert np.abs(want).max() > 1e-6 * scale   # a residual, not round-off
    assert np.abs(want - got).max() <= RES_TOL * scale


def test_derivatives_match_jax(wing):
    check_flat_derivatives(wing, tol=DERIV_TOL)


def test_second_order_advection_matches_jax(wing):
    """Second-order (van-Albada MUSCL) advection of k and omega: the block
    residual to 1e-12 of the flux scale."""
    cfg = {"turb_order": "second order"}
    want, got = block_residual_pair(wing.js, wing.ts, wing.wj, wing.wt, cfg)
    first, _ = block_residual_pair(wing.js, wing.ts, wing.wj, wing.wt)
    scale = flux_scale(wing.wj[0], wing.js.metrics_list[0])
    assert np.abs(want - got).max() <= RES_TOL * scale
    assert np.abs(want - first).max() > 1e-9 * scale


@pytest.mark.slow
def test_second_order_derivatives_match_jax(wing):
    """Slow: 15 s on one CPU worker, the JAX package's compile."""
    check_block_derivatives(wing, {"turb_order": "second order"},
                            tol=DERIV_TOL)


@pytest.mark.slow
def test_free_stream_derivatives_match_eager_jax():
    """From the exact free stream the port's jvp and vjp of the SST block
    residual follow the JAX package's op-by-op ones (slow: 30 s on one CPU
    worker, the op-by-op compiles)."""
    js, ts = solvers("rans_wing", **SST)
    wj, wt = js._filled_w()[0], ts._filled_w()[0]
    mj, mt = js.metrics_list[0], ts.metrics_list[0]
    dj = js.extras_list[0]["walldist"]
    dt = ts.extras_list[0]["walldist"]
    rng = np.random.default_rng(5)
    v = rng.standard_normal(wt.shape) * np.abs(wt.numpy())
    u = rng.standard_normal((16, 8, 8, 2))

    def fj(w):
        return jsst.sst_residual(w, jpressure(w), mj, js.cfg, js.ref, dj)

    def ft(w):
        return tsst.sst_residual(w, tpressure(w), mt, ts.cfg, ts.ref, dt)

    jv_j = jax.jvp(fj, (wj,), (jnp.asarray(v),))[1]
    vj_j = jax.vjp(fj, wj)[1](jnp.asarray(u))[0]
    jv_t = torch.func.jvp(ft, (wt,), (torch.from_numpy(v),))[1]
    vj_t = torch.func.vjp(ft, wt)[1](torch.from_numpy(u))[0]
    assert bool(torch.isfinite(jv_t).all() and torch.isfinite(vj_t).all())
    assert rel(jv_j, jv_t.numpy()) < DERIV_TOL
    assert rel(vj_j, vj_t.numpy()) < DERIV_TOL


def test_free_stream_preserved_on_perturbed_cube():
    """The mean-flow rows of the uniform free stream vanish with SST (the
    k and omega rows carry the free stream's decay and do not)."""
    solver = ADFLOW(options={"equationType": "RANS",
                             "turbulenceModel": "SST",
                             "printIterations": False,
                             "printTiming": False},
                    mesh=cube_mesh(n=6, perturb=0.2, seed=2), device="cpu")
    r = solver.getResidual(AeroProblem(name="fs", mach=0.3, alpha=2.0,
                                       reynolds=1e6))[0]
    assert r.shape[-1] == 7 and bool(torch.isfinite(r).all())
    assert float(torch.max(torch.abs(r[..., :5]))) < 1e-12


def test_line_pc_apply_matches_jax(wing):
    """The 7-equation line PC (mean flow and the k, omega tridiagonals)
    built by the port and applied to a seeded vector."""
    assert wing.tf.packer.nw == 7
    check_pc_apply(wing, tol=DERIV_TOL)


@pytest.mark.slow
def test_ank_step_matches_jax(wing):
    check_ank_step(wing, "coupled", SHORT)


def test_traced_winf_is_the_primal_free_stream(wing):
    """The adjoint's traced free stream at the base point is the primal's
    ``ref.winf()``, k_inf and omega_inf included; the JAX package's
    ``traced_winf`` appends nu_tilde_inf and 1.0 there instead (its
    entries 5 and 6 differ: the quirk the port does not copy)."""
    from adflow_torch.adjoint import api as tapi
    from adflow_torch.interop import params_from_numpy
    from adflow_tpu.adjoint import api as japi
    from tests.torch_pairs import jax_params

    js, ts = wing.js, wing.ts
    params = params_from_numpy(jax_params(js))
    got = tapi.traced_winf(tapi.traced_reference_state(ts.ref, params))
    want = ts.ref.winf()
    assert got.shape == (7,)
    assert np.abs(got.numpy() - want).max() <= 1e-15 * np.abs(want).max()
    assert abs(got[6].item() / want[6] - 1.0) < 1e-15
    jw = np.asarray(japi.traced_winf(japi.traced_reference_state(
        js.ref, {k: jnp.asarray(v) for k, v in jax_params(js).items()})))
    assert np.abs(jw[:5] - want[:5]).max() < 1e-15
    assert jw[5] != want[5] and jw[6] == 1.0 != want[6]


def test_adjoint_residual_vjp_is_the_primal_residuals(wing):
    """The port's adjoint residual (``AdjointFns.res`` at the base design
    variables) has the vjp in w of the residual the primal solves, the JAX
    package's ``residual_list`` with the primal's free stream (its Newton
    ``res_flat``); the JAX adjoint's own residual differs from it."""
    from adflow_torch.interop import params_from_numpy
    from tests.torch_pairs import jax_params

    js, ts = wing.js, wing.ts
    jfns, tfns = js._adjoint_fns(), ts._adjoint_fns()
    wvec, xvec = (np.asarray(v) for v in js._wx_vecs())
    pj = jax_params(js)
    cot = np.random.default_rng(9).standard_normal(wvec.shape)
    want, r_primal, r_adj = jax.jit(lambda w, x, p, c: (
        jax.vjp(wing.jf.res_flat, w)[1](c)[0], wing.jf.res_flat(w),
        jfns.res(w, x, p)))(jnp.asarray(wvec), jnp.asarray(xvec), pj,
                            jnp.asarray(cot))
    params = params_from_numpy(pj)
    got = torch.func.vjp(lambda w: tfns.res(w, torch.tensor(xvec), params),
                         torch.tensor(wvec))[1](torch.tensor(cot))[0]
    assert rel(want, got.numpy()) < DERIV_TOL
    assert rel(r_primal, r_adj) > 1e-6
