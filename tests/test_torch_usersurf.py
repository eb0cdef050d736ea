"""The port's user integration surfaces and cp-target inverse design
against the JAX package, float64 on the CPU:

- ``build_integration_surface``: the gather table (blocks, flat indices,
  trilinear weights, triangles, area vectors, orphans) equal exactly, for
  quads and triangles; ``read_plot3d_surf`` equal;
- ``integrate_user_surface`` (its six functions) through
  ``addIntegrationSurface`` and ``evalFunctions`` at the seeded perturbed
  free stream, to 1e-12, on the channel and on the wing;
- ``cperror2`` with ``setTargetCp`` through ``evalFunctions``, to 1e-12;
- the adjoint's functions with both: their gradients in w, x and every
  design variable to 1e-10 (the JAX side under ``jax.jit``); slow: the
  ``evalFunctionsSens`` totals of a user-surface function and of cperror2,
  xv included, to 1e-9;
- the uniform free stream's plane integral, exact (the JAX package's
  tests/test_user_surface.py).
"""

import numpy as np
import pytest
import torch

TOL = 1e-12


@pytest.fixture(scope="module")
def tp():
    from tests import torch_pairs
    return torch_pairs


def _tables(package, mesh, pts, conn):
    import importlib

    us = importlib.import_module(f"{package}.physics.usersurf")
    x = [np.asarray(b.x) for b in mesh.blocks]
    return us.build_integration_surface(mesh, x, pts, conn, "s",
                                        is_inflow=False)


@pytest.mark.parametrize("tri", [False, True], ids=["quads", "triangles"])
def test_tables_match_jax(tp, tri):
    import adflow_torch.meshgen.analytic as tm
    import adflow_tpu.meshgen.analytic as jm

    pts, conn = tp.plane(*tp.PLANES["channel"], n=5)
    if tri:
        conn = np.concatenate([conn[:, [0, 1, 2]], conn[:, [0, 2, 3]]])
    # a plane reaching past the channel's side: some elements are orphans
    pts = pts * np.array([1.0, 1.2, 1.0])
    want = _tables("adflow_tpu", jm.channel_mesh(16, 8, 2), pts, conn)
    got = _tables("adflow_torch", tm.channel_mesh(16, 8, 2), pts, conn)
    assert got.n_orphans == want.n_orphans > 0
    for f in ("pts", "conn", "blk", "gather_flat", "weights", "svec"):
        a, b = getattr(want, f), getattr(got, f)
        assert a.shape == b.shape and np.array_equal(a, b), f
    assert (got.family, got.is_inflow) == ("s", False)


def test_read_plot3d_matches_jax(tmp_path):
    from adflow_torch.physics.usersurf import read_plot3d_surf
    from adflow_tpu.physics.usersurf import read_plot3d_surf as jax_read

    rng = np.random.default_rng(0)
    lines = ["2", "3 4 1", "2 3"]
    for ni, nj in ((3, 4), (2, 3)):
        lines += [" ".join(f"{v:.12e}" for v in rng.standard_normal(ni * nj))
                  for _ in range(3)]
    path = tmp_path / "surf.xyz"
    path.write_text("\n".join(lines) + "\n")
    for a, b in zip(jax_read(str(path)), read_plot3d_surf(str(path))):
        assert np.array_equal(a, b)


@pytest.fixture(scope="module", params=["channel", "euler_wing"])
def surf_pair(request, tp):
    case = request.param
    js, ts, _, _, _ = tp.newton_pair(case)
    names = tp.add_planes(js, ts, case)
    w0 = tp.perturbed(np.asarray(js._wx_vecs()[0]), ts._newton_packer().nw)
    js.setStates(w0)
    ts.setStates(w0)
    return case, js, ts, names


def test_user_surface_functions_match_jax(surf_pair):
    _, js, ts, names = surf_pair
    fj = js.evalFunctions(js.curAP, {}, names)
    ft = ts.evalFunctions(ts.curAP, {}, names)
    assert set(fj) == set(ft) and len(ft) == 6
    for k in fj:
        assert abs(ft[k] - fj[k]) <= TOL * abs(fj[k]), (k, fj[k], ft[k])
    assert ft[f"{ts.curAP.name}_plane_mdot"] > 0.0


def test_cperror2_matches_jax(surf_pair, tp):
    _, js, ts, _ = surf_pair
    tgt = tp.wall_targets(ts)
    js.setTargetCp(tgt)
    ts.setTargetCp(tgt)
    fj = js.evalFunctions(js.curAP, {}, ["cperror2", "cl", "cd"])
    ft = ts.evalFunctions(ts.curAP, {}, ["cperror2", "cl", "cd"])
    for k in fj:
        assert abs(ft[k] - fj[k]) <= TOL * abs(fj[k]), (k, fj[k], ft[k])
    with pytest.raises(ValueError, match="CpTargets length"):
        ts.setTargetCp(np.append(tgt, 0.0))


def test_adjoint_functions_match_jax(surf_pair, tp):
    """The gradients of a user-surface function and of cperror2 in w, x and
    the design variables: the adjoint's functions take both."""
    _, js, ts, names = surf_pair
    tgt = tp.wall_targets(ts, seed=1)
    for s in (js, ts):
        s.setTargetCp(tgt)
        s._afns = None
    tp.check_function_gradients(js, ts, [names[0], names[1], "cperror2"],
                                jit=True)


@pytest.mark.slow
@pytest.mark.parametrize("func", ["plane_mavgptot", "cperror2"])
def test_sens_match_jax(tp, func):
    js, ts = tp.adjoint_pair("euler_wing", **tp.FIXED_20)
    tp.add_planes(js, ts, "euler_wing")
    tgt = tp.wall_targets(ts)
    js.setTargetCp(tgt)
    ts.setTargetCp(tgt)
    tp.check_sens(tp.jitted_sens(js, ts, func), func, converged=False)


def test_uniform_freestream_plane_is_exact(tp):
    from adflow_torch.api.solver import ADFLOW
    from adflow_torch.core.refstate import AeroProblem
    from adflow_torch.meshgen.analytic import cube_mesh

    s = ADFLOW(options=dict({"equationType": "euler"}, **tp.QUIET),
               mesh=cube_mesh(n=6), device="cpu")
    s.addIntegrationSurface(tp.plane((0.2, 0.2), (0.8, 0.8), 0.5, n=6),
                            "mid", isInflow=True)
    ap = AeroProblem(name="u", mach=0.5, alpha=0.0,
                     evalFuncs=["mid_mdot", "mid_area", "mid_mavgmn"])
    f = s.evalFunctions(ap, {})
    assert abs(f["u_mid_area"] - 0.36) < 1e-12
    assert abs(f["u_mid_mdot"] - 0.5 * 0.36) < 1e-10 * 0.18
    assert abs(f["u_mid_mavgmn"] - 0.5) < 1e-10
