"""The measured errors of the other solvers' CPU parity with the JAX package
(float64): the comparisons of the fast cases of tests/test_torch_dadi.py,
_multigrid.py, _amg.py, _unsteady.py and _time_spectral.py printed rather
than asserted:

    python tools/solver_parity.py

Needs the JAX package's environment (run from the repository's root, on
the CPU). Each line is the largest difference over the largest entry of
the JAX package's result, at the seeded perturbed free stream of
tests/torch_pairs.py.
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from adflow_torch.solvers import amg, dadi, smoothers, unsteady  # noqa: E402
from adflow_torch.solvers import multigrid as mg  # noqa: E402
from adflow_torch.solvers import timespectral as tsm  # noqa: E402
from adflow_tpu.solvers import amg as jamg  # noqa: E402
from adflow_tpu.solvers import dadi as jdadi  # noqa: E402
from adflow_tpu.solvers import multigrid as jmg  # noqa: E402
from adflow_tpu.solvers import smoothers as jsmoothers  # noqa: E402
from adflow_tpu.solvers import timespectral as jts  # noqa: E402
from adflow_tpu.solvers import unsteady as junsteady  # noqa: E402
from tests.torch_pairs import perturbed, rel, solvers, variant_pair  # noqa


def interior(a):
    return np.asarray(a)[2:-2, 2:-2, 2:-2]


def main():
    rng = np.random.default_rng(1)
    r = rng.standard_normal((16, 8, 8, 5))
    print(f"residual_averaging: {rel(jsmoothers.residual_averaging(jnp.asarray(r), 0.5), smoothers.residual_averaging(torch.from_numpy(r), 0.5).numpy()):.2e}")

    euler = variant_pair("euler_wing")
    js, ts = euler.js, euler.ts
    shape = tuple(n - 4 for n in euler.wt[0].shape[:3])
    dtinv = np.random.default_rng(2).uniform(1.0, 2.0, shape)
    dj = jdadi.build_dadi_data(euler.wj[0], js.metrics_list[0], js.cfg,
                               js.ref, jnp.asarray(dtinv), relax=0.9)
    dt = dadi.build_dadi_data(euler.wt[0], ts.metrics_list[0], ts.cfg,
                              ts.ref, torch.from_numpy(dtinv), relax=0.9)
    v = np.random.default_rng(3).standard_normal(shape + (5,))
    print(f"dadi_apply, Euler wing: {rel(jdadi.dadi_apply(dj, jnp.asarray(v)), dadi.dadi_apply(dt, torch.from_numpy(v)).numpy()):.2e}")
    nj, _ = jsmoothers.dadi_iteration(js.w_list, js.metrics_list, js.topo,
                                      js.cfg, js.ref, js.winf, 5.0)
    nt, _ = smoothers.dadi_iteration(ts.w_list, ts.metrics_list, ts.topo,
                                     ts.cfg, ts.ref, ts.winf, 5.0)
    print(f"dadi_iteration, Euler wing: {rel(interior(nj[0]), interior(nt[0])):.2e}")

    lj = jmg.build_mg_levels(js.mesh, js.x_list, js.cfg, 3, js.dtype)
    lt = mg.build_mg_levels(ts.mesh, ts.x_list, ts.cfg, 3)
    print("build_mg_levels, Euler wing, vol and siE per level: " + ", ".join(
        f"{rel(a.metrics_list[0].vol, b.metrics_list[0].vol.numpy()):.2e} "
        f"{rel(a.metrics_list[0].siE, b.metrics_list[0].siE.numpy()):.2e}"
        for a, b in zip(lj, lt)))
    f = lt[0].factors[0]
    w_c = mg.restrict_state(euler.wt[0], lt[0].vols[0], lt[1].vols[0], f)
    forcing = 1e-3 * np.random.default_rng(8).standard_normal(
        tuple(n - 4 for n in w_c.shape[:3]) + (5,))
    wj, _ = jmg.rk_smooth([jnp.asarray(w_c.numpy())], lj[1],
                          jmg._level_cfg(js.cfg, 1), js.ref, js.winf, 0.5,
                          [jnp.asarray(forcing)])
    wt, _ = mg.rk_smooth([w_c], lt[1], mg._level_cfg(ts.cfg, 1), ts.ref,
                         ts.winf, 0.5, [torch.from_numpy(forcing)])
    print(f"forced rk_smooth, 8x4x4 level: {rel(interior(wj[0]), interior(wt[0])):.2e}")

    for transpose in (False, True):
        kw = dict(levels=3, n_smooth=1, axes=(1, 0, 2), kappa=0.25,
                  transpose=transpose)
        aj = jamg.build_amg_pc(euler.wj[0], js.metrics_list[0], js.cfg,
                               js.ref, jnp.asarray(dtinv), **kw)
        at = amg.build_amg_pc(euler.wt[0], ts.metrics_list[0], ts.cfg,
                              ts.ref, torch.from_numpy(dtinv), **kw)
        print(f"stencil D, Euler wing{' (transposed)' * transpose}: "
              f"{rel(aj.ops[0].D, at.ops[0].D.numpy()):.2e}; "
              f"amg_pc_apply: "
              f"{rel(jamg.amg_pc_apply(aj, jnp.asarray(v)), amg.amg_pc_apply(at, torch.from_numpy(v)).numpy()):.2e}")

    plate = variant_pair("rans_plate")
    pj, pt = plate.js, plate.ts
    wn = [np.asarray(w) * 0.999 for w in pj.w_list]
    wm = [np.asarray(w) * 1.002 for w in pj.w_list]
    coefs = unsteady.bdf_coefficients(2, False)
    want = junsteady.unsteady_residual_list(
        pj.w_list, [jnp.asarray(w) for w in wn], [jnp.asarray(w) for w in wm],
        pj.metrics_list, pj.topo, pj.cfg, pj.ref, pj.winf, 0.01, coefs,
        pj.extras_list)
    got = unsteady.unsteady_residual_list(
        pt.w_list, [torch.from_numpy(w) for w in wn],
        [torch.from_numpy(w) for w in wm], pt.metrics_list, pt.topo, pt.cfg,
        pt.ref, pt.winf, 0.01, coefs, pt.extras_list)
    print("unsteady_residual_list BDF2, RANS plate, per channel: " + ", ".join(
        f"{rel(np.asarray(want[0])[..., c], got[0][..., c].numpy()):.2e}"
        for c in range(6)))

    wj, ij = junsteady.solve_unsteady_explicit_rk(
        js.w_list, js.metrics_list, js.topo, js.cfg, js.ref, js.winf,
        n_steps=2, dt=1e-4)
    wt, it = unsteady.solve_unsteady_explicit_rk(
        ts.w_list, ts.metrics_list, ts.topo, ts.cfg, ts.ref, ts.winf,
        n_steps=2, dt=1e-4)
    print(f"two RK4 steps, Euler wing: state {rel(interior(wj[0]), interior(wt[0])):.2e}, norms {rel(ij.inner_res, it.inner_res):.2e}")

    omega = 2.0 * np.pi
    sj, st = solvers("euler_wing", equationMode="time spectral",
                     timeIntervals=3, omegaFourier=omega)
    rj, period = jts.instance_refstates(sj.curAP, 3, omega, 1.0, 2, 0)
    rt, _ = tsm.instance_refstates(st.curAP, 3, omega, 1.0, 2, 0)
    wj, wt = [], []
    for q in range(3):
        w0 = perturbed(np.asarray(sj.getStates()), 5, seed=q)
        sj.setStates(w0)
        st.setStates(w0)
        wj.append(list(sj.w_list))
        wt.append(list(st.w_list))
    kw = dict(cfl=1.2, n_cycles=1, chunk=1)
    with jax.disable_jit():
        oj, ij = jts.solve_time_spectral(
            wj, sj.metrics_list, sj.topo, sj.cfg, rj,
            [jnp.asarray(r.winf()) for r in rj], period, **kw)
    ot, it = tsm.solve_time_spectral(
        wt, st.metrics_list, st.topo, st.cfg, rt,
        [torch.tensor(r.winf()) for r in rt], period, **kw)
    print("time-spectral cycle, 3 instances: " + ", ".join(
        f"{rel(interior(oj[q][0]), interior(ot[q][0])):.2e}"
        for q in range(3)) + f"; norm {rel(ij.history, it.history):.2e}")


if __name__ == "__main__":
    main()
