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
# the cases of the physics variants: the viscous wing with RANS, and the
# channel (imin subsonic inflow, imax subsonic outflow, slip walls)
VARIANT_CASES = dict(CASES, **{
    "rans_wing": (
        {"equationType": "RANS"},
        dict(name="m6", mach=0.84, alpha=3.06, reynolds=11.72e6,
             evalFuncs=["cl", "cd"]),
        "wing_omesh", dict(ni=16, nj=8, nk=8, viscous=True)),
    "channel": (
        {"equationType": "euler"},
        dict(name="ch", mach=0.3, alpha=0.0, evalFuncs=["mdot"]),
        "channel_mesh", dict(ni=16, nj=8, nk=2)),
})


def solvers(case, ap_changes=None, **options):
    """(JAX solver, port solver) with the case's aero problem, changed by
    ``ap_changes``, set."""
    opts, ap, mesh_fn, mesh_kw = VARIANT_CASES[case]
    ap = dict(ap, **(ap_changes or {}))
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


def newton_pair(case, ap_changes=None, **options):
    """Both packages' solvers and Newton functions, and the seeded
    perturbed flat state."""
    js, ts = solvers(case, ap_changes, **options)
    jf = jax_newton.build_newton_fns(js.w_list, js.metrics_list, js.topo,
                                     js.cfg, js.ref, js.winf, js.extras_list)
    tf = newton.build_newton_fns(ts.w_list, ts.metrics_list, ts.topo,
                                 ts.cfg, ts.ref, ts.winf, ts.extras_list)
    w0 = perturbed(jf.packer.pack_w(js.w_list), jf.packer.nw)
    return js, ts, jf, tf, w0


def variant_pair(case, ap_changes=None, **options):
    """Both packages' solvers and Newton functions at the case's seeded
    perturbed free stream, set as the solvers' states, and the halo-filled
    states: a namespace of js, ts, jf, tf, w0 (flat numpy), wj and wt (the
    filled block lists)."""
    import types

    js, ts, jf, tf, w0 = newton_pair(case, ap_changes, **options)
    js.setStates(w0)
    ts.setStates(w0)
    return types.SimpleNamespace(js=js, ts=ts, jf=jf, tf=tf, w0=w0,
                                 wj=js._filled_w(), wt=ts._filled_w())


def flux_scale(w, metrics):
    """The largest |p| times the largest interior face area of a filled
    block (numpy or JAX arrays): the scale of a face flux."""
    w = np.asarray(w)
    p = 0.4 * (w[..., 4] - 0.5 * np.sum(w[..., 1:4] ** 2, axis=-1)
               / w[..., 0])
    smax = max(float(np.linalg.norm(np.asarray(s), axis=-1).max())
               for s in (metrics.si, metrics.sj, metrics.sk))
    return float(np.abs(p).max()) * smax


def block_residual_pair(js, ts, wj, wt, cfg_changes=None, block=0):
    """Both packages' ``block_residual`` of one filled block, with the
    solvers' configurations changed by ``cfg_changes``: (JAX, port) as
    numpy. The JAX side under ``jax.jit``, which compiles faster than its
    op-by-op evaluation."""
    import dataclasses

    import jax

    from adflow_torch.physics import residual as tres
    from adflow_tpu.physics import residual as jres

    cj = dataclasses.replace(js.cfg, **(cfg_changes or {}))
    ct = dataclasses.replace(ts.cfg, **(cfg_changes or {}))
    exj = js.extras_list[block] if js.extras_list else None
    ext = ts.extras_list[block] if ts.extras_list else None
    want = jax.jit(lambda w: jres.block_residual(
        w, js.metrics_list[block], cj, js.ref, exj,
        por=js.topo.blocks[block].por))(wj[block])
    got = tres.block_residual(wt[block], ts.metrics_list[block], ct, ts.ref,
                              ext, por=ts.topo.blocks[block].por)
    return np.asarray(want), got.numpy()


def check_flat_derivatives(pair, seed=0, tol=1e-10):
    """The jvp and vjp of the whole residual (``res_flat``: halo fill and
    every block) at a ``variant_pair``'s state, from seeded directions,
    the JAX side under one ``jax.jit``: to ``tol`` relative. Returns the
    two errors."""
    import jax

    w = pair.w0
    rng = np.random.default_rng(seed)
    v = rng.standard_normal(w.shape) * np.abs(w)
    u = rng.standard_normal(w.shape)
    res_j, res_t = pair.jf.res_flat, pair.tf.res_flat
    jv_j, vj_j = jax.jit(lambda a, d, c: (
        jax.jvp(res_j, (a,), (d,))[1], jax.vjp(res_j, a)[1](c)[0]))(
        jnp.asarray(w), jnp.asarray(v), jnp.asarray(u))
    wt = torch.from_numpy(w)
    jv_t = torch.func.jvp(res_t, (wt,), (torch.from_numpy(v),))[1]
    vj_t = torch.func.vjp(res_t, wt)[1](torch.from_numpy(u))[0]
    assert bool(torch.isfinite(jv_t).all() and torch.isfinite(vj_t).all())
    errs = rel(jv_j, jv_t.numpy()), rel(vj_j, vj_t.numpy())
    assert max(errs) < tol, errs
    return errs


def check_block_derivatives(pair, cfg_changes=None, tol=1e-10, seed=3):
    """The jvp and vjp of one filled block's ``block_residual`` (the halo
    fill's are ``check_flat_derivatives``'), with the configuration
    changed by ``cfg_changes``, from seeded directions; the JAX side under
    one ``jax.jit``: to ``tol`` relative."""
    import dataclasses

    import jax

    from adflow_torch.physics import residual as tres
    from adflow_tpu.physics import residual as jres

    js, ts = pair.js, pair.ts
    cj = dataclasses.replace(js.cfg, **(cfg_changes or {}))
    ct = dataclasses.replace(ts.cfg, **(cfg_changes or {}))
    ex_j = js.extras_list[0] if js.extras_list else None
    ex_t = ts.extras_list[0] if ts.extras_list else None
    por_j, por_t = js.topo.blocks[0].por, ts.topo.blocks[0].por
    mj, mt = js.metrics_list[0], ts.metrics_list[0]
    wj, wt = pair.wj[0], pair.wt[0]
    rng = np.random.default_rng(seed)
    v = rng.standard_normal(wt.shape) * np.abs(wt.numpy())
    u = rng.standard_normal(tuple(n - 4 for n in wt.shape[:3])
                            + (wt.shape[-1],))

    def fj(w):
        return jres.block_residual(w, mj, cj, js.ref, ex_j, por=por_j)

    def ft(w):
        return tres.block_residual(w, mt, ct, ts.ref, ex_t, por=por_t)

    jv_j, vj_j = jax.jit(lambda w, d, c: (
        jax.jvp(fj, (w,), (d,))[1], jax.vjp(fj, w)[1](c)[0]))(
        wj, jnp.asarray(v), jnp.asarray(u))
    jv_t = torch.func.jvp(ft, (wt,), (torch.from_numpy(v),))[1]
    vj_t = torch.func.vjp(ft, wt)[1](torch.from_numpy(u))[0]
    errs = rel(jv_j, jv_t.numpy()), rel(vj_j, vj_t.numpy())
    assert max(errs) < tol, errs
    return errs


def check_pc_apply(pair, tol=1e-10, seed=8):
    """The port's line PC built at a ``variant_pair``'s state and CFL 7,
    applied to a seeded vector, against the JAX package's."""
    axes, kappa = newton._pc_params(pair.ts.options)
    pj = pair.jf.build_pc(jnp.asarray(pair.w0), CFL, axes=axes, kappa=kappa)
    pt = pair.tf.build_pc(torch.from_numpy(pair.w0), CFL, axes=axes,
                          kappa=kappa)
    v = np.random.default_rng(seed).standard_normal(pair.w0.shape)
    want = jax_newton.pc_apply_vec(pj, pair.jf.packer, jnp.asarray(v))
    got = newton.pc_apply_vec(pt, pair.tf.packer, torch.from_numpy(v))
    assert rel(want, got.numpy()) < tol


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
    if not isinstance(pair, tuple):
        pair = (pair.js, pair.ts, pair.jf, pair.tf, pair.w0)
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


# -- the adjoint of both packages --------------------------------------------

# psi and the evalFunctionsSens totals; the residual vjp and the function
# gradients (f64, the same operator, PC and Krylov iterations)
SENS_TOL = 1e-9
VJP_TOL = 1e-10
# the fixed-iteration RANS plate adjoint: 20 GMRES iterations in one cycle,
# a tolerance small enough that neither package stops early
FIXED_20 = {"adjointSubspaceSize": 20, "adjointMaxIter": 20,
            "adjointL2Convergence": 1e-14}


def adjoint_pair(case, ap_changes=None, **options):
    """Both packages' solvers with the case's seeded perturbed state set."""
    js, ts = solvers(case, ap_changes, **options)
    w0 = perturbed(np.asarray(js._wx_vecs()[0]), ts._newton_packer().nw)
    js.setStates(w0)
    ts.setStates(w0)
    return js, ts


def jax_params(js):
    """The JAX solver's design variables as numpy."""
    return {k: np.asarray(v) for k, v in js._ap_params(js.curAP).items()}


def sens_pair(case, funcs, **options):
    """Both packages' evalFunctionsSens of ``funcs`` at the perturbed
    state: (JAX solver, port solver, JAX totals, port totals)."""
    js, ts = adjoint_pair(case, **options)
    sj = js.evalFunctionsSens(js.curAP, {}, funcs)
    st = ts.evalFunctionsSens(ts.curAP, {}, funcs)
    return js, ts, sj, st


def jitted_sens_pair(case, func, **options):
    """As ``sens_pair`` for one function, with the JAX totals computed as
    the JAX package's evalFunctionsSens computes them (its
    ``build_adjoint_fns`` and ``solve_adjoint_system``, then dI/d* =
    dI/d*|direct - psi^T dR/d*), under one ``jax.jit``: its eager
    evalFunctionsSens compiles op by op and takes minutes on the RANS plate
    (test_converged_rans_adjoint_matches_jax), the jitted reference about
    one. The JAX solver's psi cache and ``adjointFailed`` are set
    as its evalFunctionsSens sets them."""
    return jitted_sens(*adjoint_pair(case, **options), func)


def jitted_sens(js, ts, func):
    """``jitted_sens_pair`` of two prepared solvers."""
    import jax

    from adflow_tpu.adjoint.api import solve_adjoint_system
    from adflow_tpu.core.refstate import R_GAS

    fns = js._adjoint_fns()
    js._newton_fns()
    opt = js.options
    sub = int(opt["adjointSubspaceSize"])

    @jax.jit
    def totals(wvec, xvec, params):
        dIdw = jax.grad(lambda w: fns.funcs(w, xvec, params)[func])(wvec)
        sol = solve_adjoint_system(
            fns, js, wvec, xvec, params, dIdw,
            tol=float(opt["adjointL2Convergence"]),
            abs_tol=float(opt["adjointL2ConvergenceRel"]), subspace=sub,
            restarts=max(1, int(opt["adjointMaxIter"]) // sub))
        gI_x, gI_p = jax.grad(lambda x, p: fns.funcs(wvec, x, p)[func],
                              argnums=(0, 1))(xvec, params)
        gR_x, gR_p = jax.vjp(lambda x, p: fns.res(wvec, x, p), xvec,
                             params)[1](sol.x)
        return sol, gI_x - gR_x, {k: gI_p[k] - gR_p[k] for k in params}

    sol, dxv, dp = totals(*js._wx_vecs(), js._ap_params(js.curAP))
    sj = {k: float(v) for k, v in dp.items() if k != "xref"}
    sj.update(xref=np.asarray(dp["xref"]), xv=np.asarray(dxv),
              rho=R_GAS * js.curAP.T * sj["P"])
    js._psi_cache = {(js.curAP.name, func): sol.x}
    js.adjointFailed = not bool(sol.converged)
    st = ts.evalFunctionsSens(ts.curAP, {}, [func])
    return js, ts, {f"{js.curAP.name}_{func}": sj}, st


def check_sens(pair, func, converged):
    """psi and every total of ``func`` agree to SENS_TOL; both adjoint
    solves converged, or both did not."""
    js, ts, sj, st = pair
    key = (ts.curAP.name, func)
    assert rel(js._psi_cache[key], ts._psi_cache[key].numpy()) < SENS_TOL
    assert js.adjointFailed == ts.adjointFailed == (not converged)
    want, got = sj[f"{ts.curAP.name}_{func}"], st[f"{ts.curAP.name}_{func}"]
    assert set(want) == set(got)
    for k in want:
        assert np.shape(want[k]) == np.shape(got[k]), k
        assert rel(want[k], got[k]) < SENS_TOL, (k, want[k], got[k])
    return want, got


def _maybe_jit(fn, jit):
    import jax
    return jax.jit(fn) if jit else fn


def check_residual_vjp(js, ts, seed=0, jit=False):
    """The residual's vjp with respect to w, x and every design variable,
    from one seeded cotangent. ``jit``: the JAX side under ``jax.jit``,
    which compiles faster than its first eager call."""
    import jax

    from adflow_torch.interop import params_from_numpy

    jf, tf = js._adjoint_fns(), ts._adjoint_fns()
    wvec, xvec = (np.asarray(v) for v in js._wx_vecs())
    pj = jax_params(js)
    cot = np.random.default_rng(seed).standard_normal(wvec.shape)
    want = _maybe_jit(lambda w, x, p, c: jax.vjp(jf.res, w, x, p)[1](c),
                      jit)(jnp.asarray(wvec), jnp.asarray(xvec), pj,
                           jnp.asarray(cot))
    got = torch.func.vjp(tf.res, torch.tensor(wvec), torch.tensor(xvec),
                         params_from_numpy(pj))[1](torch.tensor(cot))
    assert rel(want[0], got[0].numpy()) < VJP_TOL
    assert rel(want[1], got[1].numpy()) < VJP_TOL
    assert set(want[2]) == set(got[2])
    for k in want[2]:
        assert rel(want[2][k], got[2][k].numpy()) < VJP_TOL, k
    return want


def check_function_gradients(js, ts, funcs, jit=False):
    """The gradients of each function with respect to w, x and every
    design variable (``jit`` as in ``check_residual_vjp``)."""
    import jax

    from adflow_torch.interop import params_from_numpy

    jf, tf = js._adjoint_fns(), ts._adjoint_fns()
    wvec, xvec = (np.asarray(v) for v in js._wx_vecs())
    pj = jax_params(js)
    for name in funcs:
        want = _maybe_jit(jax.grad(lambda w, x, p: jf.funcs(w, x, p)[name],
                                   argnums=(0, 1, 2)), jit)(
            jnp.asarray(wvec), jnp.asarray(xvec), pj)
        got = torch.func.grad(lambda w, x, p: tf.funcs(w, x, p)[name],
                              argnums=(0, 1, 2))(
            torch.tensor(wvec), torch.tensor(xvec), params_from_numpy(pj))
        assert float(np.abs(want[0]).max()) > 0.0
        assert rel(want[0], got[0].numpy()) < VJP_TOL, name
        assert rel(want[1], got[1].numpy()) < VJP_TOL, name
        for k in want[2]:
            assert rel(want[2][k], got[2][k].numpy()) < VJP_TOL, (name, k)


# -- overset meshes of both packages ----------------------------------------

def _pkg(package, module):
    import importlib
    return importlib.import_module(f"{package}.{module}")


def box_in_box(package, n_bg=16, n_in=20):
    """tests/test_overset.py's mesh in ``package`` ('adflow_tpu' or
    'adflow_torch'): the far-field box [0,1]^3 and an inner box
    [0.25,0.75]^3 with OVERSET faces."""
    m = _pkg(package, "core.mesh")
    bg = _pkg(package, "meshgen.analytic").cube_mesh(n=n_bg).blocks[0]
    xs = [np.linspace(0.25, 0.75, n_in + 1)] * 3
    x = np.stack(np.meshgrid(*xs, indexing="ij"), axis=-1)
    inner = m.Block(name="inner", x=x, bcs=[
        m.BCSubface(face=f, bc=m.BCType.OVERSET, family="ovs")
        for f in m.Face])
    return m.MultiBlockMesh(blocks=[bg, inner], name="boxbox")


def box_cut(bi, centers):
    """tests/test_overset.py's explicit cut: a hole in the background under
    the inner box's core."""
    if bi != 0:
        return np.zeros(len(centers), bool)
    return np.max(np.abs(centers - 0.5), axis=1) < 0.1


def overset_airfoil(package, ni, nj, nk=2, radius=1.5, viscous=False):
    """The NACA 0012 O-mesh with its JMAX face OVERSET (the receiver)."""
    import dataclasses

    m = _pkg(package, "core.mesh")
    near = _pkg(package, "meshgen.analytic").naca0012_omesh(
        ni=ni, nj=nj, radius=radius, nk=nk, viscous=viscous).blocks[0]
    bcs = [(dataclasses.replace(sf, bc=m.BCType.OVERSET, family="ovs")
            if sf.face is m.Face.JMAX else sf) for sf in near.bcs]
    return m.MultiBlockMesh([dataclasses.replace(near, bcs=bcs)],
                            name="near")


def airfoil_in_box(package, ni=64, nj=16, n_bg=40, radius=1.5):
    """tests/test_overset.py's airfoil in a Cartesian background block
    (far field around, symmetry planes in z)."""
    m = _pkg(package, "core.mesh")
    near = overset_airfoil(package, ni, nj, radius=radius).blocks[0]
    xs = np.linspace(-2.0, 3.0, n_bg + 1)
    ys = np.linspace(-2.0, 2.0, n_bg + 1)
    zs = near.x[0, 0, :, 2]
    x = np.zeros((n_bg + 1, n_bg + 1, len(zs), 3))
    x[..., 0] = xs[:, None, None]
    x[..., 1] = ys[None, :, None]
    x[..., 2] = zs[None, None, :]
    F, B = m.Face, m.BCType
    bg = m.Block(name="bg", x=x, bcs=[
        m.BCSubface(F.IMIN, B.FARFIELD, family="far"),
        m.BCSubface(F.IMAX, B.FARFIELD, family="far"),
        m.BCSubface(F.JMIN, B.FARFIELD, family="far"),
        m.BCSubface(F.JMAX, B.FARFIELD, family="far"),
        m.BCSubface(F.KMIN, B.SYMMETRY, family="sym"),
        m.BCSubface(F.KMAX, B.SYMMETRY, family="sym")])
    return m.MultiBlockMesh(blocks=[near, bg], name="airfoil_box")


def airfoil_background(package, ni=40, nj=10, radius=1.2, viscous=False,
                       scale=4.0, far=6.0):
    """tests/test_overset_warp.py's mesh: the 40x10 airfoil in its generated
    background (``cartesian_background``, symmetry planes in z)."""
    near = overset_airfoil(package, ni, nj, radius=radius, viscous=viscous)
    return _pkg(package, "meshgen.cartmesh").cartesian_background(
        near, scale=scale, far=far, sym_planes=("zlow", "zhigh"))


OVERSET_MESHES = {
    "box_in_box": (lambda p: box_in_box(p), box_cut),
    "airfoil_in_box": (lambda p: airfoil_in_box(p), None),
    "airfoil_background": (lambda p: airfoil_background(p), None),
}


def overset_solvers(mesh_fn, cut=None, ap=None, **options):
    """(JAX solver, port solver) on ``mesh_fn(package)``'s mesh with the
    cut callback ``cut``, float64 on the CPU, the aero problem ``ap`` (a
    dict) set."""
    opts = dict({"equationType": "euler"}, **QUIET, **options)
    ap = ap or dict(name="ov", mach=0.5, alpha=2.0, evalFuncs=["cl", "cd"])
    js = JaxADFLOW(options=opts, mesh=mesh_fn("adflow_tpu"),
                   cutCallback=cut)
    ts = ADFLOW(options=opts, mesh=mesh_fn("adflow_torch"), device="cpu",
                cutCallback=cut)
    js.setAeroProblem(JaxAP(**ap))
    ts.setAeroProblem(AeroProblem(**ap))
    return js, ts


def overset_pair(mesh_fn, cut=None, ap=None, **options):
    """``variant_pair``'s namespace for an overset mesh: both solvers, both
    Newton functions, the seeded perturbed state set in both, the filled
    block lists."""
    import types

    js, ts = overset_solvers(mesh_fn, cut, ap, **options)
    jf = jax_newton.build_newton_fns(js.w_list, js.metrics_list, js.topo,
                                     js.cfg, js.ref, js.winf, js.extras_list)
    tf = newton.build_newton_fns(ts.w_list, ts.metrics_list, ts.topo,
                                 ts.cfg, ts.ref, ts.winf, ts.extras_list)
    w0 = perturbed(jf.packer.pack_w(js.w_list), jf.packer.nw)
    js.setStates(w0)
    ts.setStates(w0)
    return types.SimpleNamespace(js=js, ts=ts, jf=jf, tf=tf, w0=w0,
                                 wj=js._filled_w(), wt=ts._filled_w())


def wall_box(package, name, x0, x1, nx, ny=8, nz=4):
    """tests/test_zipper.py's box whose z-min face is a viscous wall over
    [x0, x1] x [0, 1]."""
    m = _pkg(package, "core.mesh")
    x = np.stack(np.meshgrid(np.linspace(x0, x1, nx + 1),
                             np.linspace(0.0, 1.0, ny + 1),
                             np.linspace(0.0, 0.5, nz + 1), indexing="ij"),
                 axis=-1)
    bcs = [m.BCSubface(face=m.Face(f), bc=m.BCType.FARFIELD, family="far")
           for f in (0, 1, 2, 3, 5)]
    bcs.append(m.BCSubface(face=m.Face(4), bc=m.BCType.NS_WALL_ADIABATIC,
                           family="wall"))
    return m.Block(name=name, x=x, bcs=bcs)


def two_patch_mesh(package, overlap=0.2, n1=24, n2=15):
    """tests/test_zipper.py's two disconnected blocks (two clusters) whose
    wall patches overlap in x by ``overlap``; ``overlap`` 0 and equal
    widths: its touching patches."""
    m = _pkg(package, "core.mesh")
    if overlap == 0.0:
        return m.MultiBlockMesh([wall_box(package, "a", 0.0, 0.5, 10),
                                 wall_box(package, "b", 0.5, 1.0, 10)],
                                name="touch")
    return m.MultiBlockMesh([wall_box(package, "fine", 0.0, 0.6, n1),
                             wall_box(package, "coarse", 0.6 - overlap, 1.0,
                                      n2)], name="twopatch")


def plane(lo, hi, x0, n=4):
    """tests/test_user_surface.py's quad grid of the plane x = ``x0`` over
    [lo[0], hi[0]] x [lo[1], hi[1]] in (y, z): (pts, conn)."""
    y = np.linspace(lo[0], hi[0], n + 1)
    z = np.linspace(lo[1], hi[1], n + 1)
    Y, Z = np.meshgrid(y, z, indexing="ij")
    pts = np.stack([np.full(Y.shape, x0), Y, Z], axis=-1).reshape(-1, 3)
    ii, jj = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    base = (ii * (n + 1) + jj).reshape(-1)
    return pts, np.stack([base, base + (n + 1), base + (n + 2), base + 1],
                         axis=1)


# a user integration surface inside each case's domain: a plane across the
# wing's wake, one across the channel (the plate's one cell in z holds no
# dual brick: the association skips such blocks, as the JAX package's does)
PLANES = {"euler_wing": ((-1.0, 0.5), (1.0, 2.5), 2.0),
          "channel": ((0.05, 0.02), (0.95, 0.18), 1.5)}
SURF_FUNCS = ("mdot", "mavgptot", "mavgttot", "mavgps", "mavgmn", "area")


def add_planes(js, ts, case, name="plane", n=4):
    """The case's plane added to both solvers as the user surface
    ``name``; returns its six function names."""
    surf = plane(*PLANES[case], n=n)
    js.addIntegrationSurface(surf, name)
    ts.addIntegrationSurface(surf, name)
    return [f"{name}_{f}" for f in SURF_FUNCS]


def wall_targets(solver, seed=0):
    """Seeded target Cp over the solver's wall faces, in patch order."""
    n = sum(int(np.prod([p.face_sl[a].stop - p.face_sl[a].start
                         for a in range(3) if a != p.axis]))
            for p in solver.wall_patches)
    return np.random.default_rng(seed).uniform(-0.5, 0.5, n)
