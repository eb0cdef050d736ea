"""Paired cases for the port's ANK/NK parity tests: the same mesh, options
and aero problem built in the JAX package and in the port (float64 on the
CPU), their Newton functions, and one seeded perturbed state.

A perturbed state rather than the exact free stream: at the free stream the
residual sits on the kink of |d2p| (the JST sensor) at far-field ghost
cells, where d2p is round-off. There the sign that picks the derivative
follows the rounding of those ghost states, which differs between the JAX
package compiled by XLA and evaluated op by op; the port follows the op by
op evaluation (tests/test_torch_solver.py::test_ank_free_stream_matches_eager_jax).
"""

import jax.numpy as jnp
import numpy as np
import torch

import adflow_torch.meshgen.analytic as meshgen
import adflow_tpu.meshgen.analytic as jax_meshgen
from adflow_torch.api.solver import ADFLOW
from adflow_torch.core.refstate import AeroProblem
from adflow_torch.interop import line_pc_from_numpy
from adflow_torch.solvers import newton
from adflow_tpu.api.solver import ADFLOW as JaxADFLOW
from adflow_tpu.core.refstate import AeroProblem as JaxAP
from adflow_tpu.solvers import newton as jax_newton

QUIET = {"printIterations": False, "printTiming": False}

CASES = {
    "euler_wing": (
        {"equationType": "euler"},
        dict(name="w", mach=0.84, alpha=3.06, evalFuncs=["cl", "cd"]),
        "wing_omesh", dict(ni=16, nj=8, nk=8)),
    "rans_plate": (
        {"equationType": "RANS"},
        dict(name="fp", mach=0.3, alpha=0.0, reynolds=1e6,
             reynoldsLength=1.0, T=300.0, evalFuncs=["cd"]),
        "flatplate_mesh", dict(ni=16, nj=12)),
}


def solvers(case, **options):
    """(JAX solver, port solver) with the case's aero problem set."""
    opts, ap, mesh_fn, mesh_kw = CASES[case]
    opts = dict(opts, **QUIET, **options)
    js = JaxADFLOW(options=opts,
                   mesh=getattr(jax_meshgen, mesh_fn)(**mesh_kw))
    js.setAeroProblem(JaxAP(**ap))
    ts = ADFLOW(options=opts, mesh=getattr(meshgen, mesh_fn)(**mesh_kw),
                device="cpu")
    ts.setAeroProblem(AeroProblem(**ap))
    return js, ts


def perturbed(w_flat, nw, seed=0, amp=1e-3):
    """The flat state plus ``amp`` times each channel's largest magnitude
    times seeded normal noise."""
    w = np.asarray(w_flat).reshape(-1, nw)
    rng = np.random.default_rng(seed)
    return (w + amp * np.abs(w).max(axis=0)
            * rng.standard_normal(w.shape)).reshape(-1)


def newton_pair(case, **options):
    """Both packages' solvers and Newton functions, and the seeded
    perturbed flat state."""
    js, ts = solvers(case, **options)
    jf = jax_newton.build_newton_fns(js.w_list, js.metrics_list, js.topo,
                                     js.cfg, js.ref, js.winf, js.extras_list)
    tf = newton.build_newton_fns(ts.w_list, ts.metrics_list, ts.topo,
                                 ts.cfg, ts.ref, ts.winf, ts.extras_list)
    w0 = perturbed(jf.packer.pack_w(js.w_list), jf.packer.nw)
    return js, ts, jf, tf, w0


# -- one Newton step of both packages ---------------------------------------

STEP_TOL = 1e-10
CFL = 7.0
# a variant's own code at a smaller cost: one turbulence subiteration and
# at most 10 Krylov iterations
SHORT = {"nSubiterTurb": 1, "ANKMaxIter": 10}


def rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / (np.abs(a).max() + 1e-300))


def pc_pair(jf, w0, cfl, js):
    """The JAX package's line-PC data at ``w0`` and ``cfl``, and the same
    data carried into the port."""
    axes, kappa = jax_newton._pc_params(js.options)
    pj = jf.build_pc(jnp.asarray(w0), cfl, axes=axes, kappa=kappa)
    return pj, [line_pc_from_numpy(
        d.axes, [tuple(np.asarray(a) for a in t) for t in d.mean],
        [None if t is None else tuple(np.asarray(a) for a in t)
         for t in d.turb], np.asarray(d.dscalar), d.turb_scale)
        for d in pj]


def check_stats(want, got):
    want, got = np.asarray(want), np.asarray(got)
    assert want.shape == got.shape
    for i, (a, b) in enumerate(zip(want, got)):
        assert abs(a - b) <= STEP_TOL * max(abs(a), 1e-30), (i, a, b)


def check_ank_step(pair, variant, options):
    """One ANK step of each package from the same state, PC data and CFL:
    the same stats and new state; returns the port's StepResult."""
    js, ts, jf, tf, w0 = pair
    pj, pt = pc_pair(jf, w0, CFL, js)
    kw = dict(segregated=variant == "segregated", approx=variant == "approx")
    wj, sj = jax_newton.make_ank_step(jf, js.options.replace(**options),
                                      **kw)(jnp.asarray(w0),
                                            jnp.asarray(CFL), pj)
    res = newton.make_ank_step(tf, ts.options.replace(**options), **kw)(
        torch.from_numpy(w0), CFL, pt)
    assert res.stats.shape == (7,)
    check_stats(sj, res.stats.numpy())
    assert rel(wj, res.w.numpy()) < STEP_TOL
    # the step moved the state and its linear solve did work
    assert rel(w0, res.w.numpy()) > 1e-6 and res.stats[4] >= 1
    return res
