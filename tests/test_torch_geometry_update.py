"""The port's geometry tail against the JAX package, float64 on the CPU:

- ``warp_mesh`` (the IDW warp, its boundary anchors and their filter) to
  1e-12 of the displacement scale;
- ``compute_wall_distances(return_assoc=True)`` to 1e-12 with the same
  association, and ``update_wall_distances`` after a warp to 1e-12;
- through ``ADFLOW(device="cpu")`` on the airfoil in its generated
  background: one ANK step of the Euler case, its stats to 1e-10 (as
  tests/test_torch_newton.py holds them); on the RANS-SA case
  ``setSurfaceCoordinates`` and ``updateGeometryInfo`` (the warp, the
  overset re-assembly, the quick wall distance), then the nodes, the wall
  distance, the overset report, the residual and the functions to 1e-10,
  and the ``getGrid``/``setGrid`` round trip;
- the adjoint on these meshes: tests/test_torch_overset_adjoint.py.

On a card (marker ``cuda``): the warp in f32 on the card against the f64
warp on the CPU, and the quick wall distance on the card against a full
search there. JAX is imported inside the tests that run it:
``python -m pytest tests/test_torch_geometry_update.py -m cuda
--noconftest``.
"""

import numpy as np
import pytest
import torch

from chip_smoke import bumped

TOL = 1e-12
STEP_TOL = 1e-10
BUMP = 0.02
RANS_AP = dict(name="ov", mach=0.5, alpha=2.0, reynolds=1e6,
               reynoldsLength=1.0, T=300.0, evalFuncs=["cl", "cd"])


@pytest.fixture(scope="module")
def tp():
    from tests import torch_pairs
    return torch_pairs


def _wall_nodes(package, mesh):
    import importlib

    surf = importlib.import_module(f"{package}.physics.surface")
    return np.concatenate([mesh.blocks[p.block].x[p.fnode_sl].reshape(-1, 3)
                           for p in surf.build_wall_patches(mesh)])


def test_warp_matches_jax(tp):
    import jax.numpy as jnp

    from adflow_torch.geom import warp as twarp
    from adflow_tpu.geom import warp as jwarp

    jm = tp.airfoil_background("adflow_tpu", viscous=True)
    tm = tp.airfoil_background("adflow_torch", viscous=True)
    a, b = jwarp._boundary_anchor_nodes(jm), twarp._boundary_anchor_nodes(tm)
    assert np.array_equal(a, b) and len(b) > 0
    pts0 = _wall_nodes("adflow_torch", tm)
    disp = bumped(pts0, BUMP) - pts0
    want = jwarp.warp_mesh(jm, [jnp.asarray(blk.x) for blk in jm.blocks],
                           pts0, disp)
    got = twarp.warp_mesh(tm, [torch.tensor(blk.x) for blk in tm.blocks],
                          pts0, disp)
    for w, g, blk in zip(want, got, tm.blocks):
        err = np.abs(np.asarray(w) - g.numpy()).max() / np.abs(disp).max()
        assert err < TOL
        assert np.abs(g.numpy() - blk.x).max() > 0.0


def test_wall_distances_match_jax(tp):
    from adflow_torch.geom import walldist as twd
    from adflow_torch.geom.metrics import cell_centers
    from adflow_tpu.geom import walldist as jwd

    jm = tp.airfoil_background("adflow_tpu", viscous=True)
    tm = tp.airfoil_background("adflow_torch", viscous=True)
    xj = [np.asarray(b.x) for b in jm.blocks]
    xt = [torch.tensor(b.x) for b in tm.blocks]
    dj, aj = jwd.compute_wall_distances(jm, xj, np.float64,
                                        return_assoc=True)
    dt, at = twd.compute_wall_distances(tm, xt, return_assoc=True)
    quads = twd.gather_wall_quads(tm, xt)
    for a, b, ia, ib, x in zip(dj, dt, aj, at, xt):
        assert tp.rel(a, b.numpy()) < TOL
        # the same quad, or one as near (a cell whose nearest point is an
        # edge two quads share): the order of equal candidates is the
        # library's top-k's
        ia = torch.tensor(np.asarray(ia))
        tie = ia != ib
        xc = cell_centers(x).reshape(-1, 3)[tie]
        assert tp.rel(twd._project_points_quads(xc, quads[ia[tie]]),
                      twd._project_points_quads(xc, quads[ib[tie]])) < TOL
    # the quick update at moved coordinates, from one stored association
    rng = np.random.default_rng(0)
    moved = [x + 1e-3 * rng.standard_normal(x.shape) for x in xj]
    uj = jwd.update_wall_distances(jm, moved, [a.numpy() for a in at],
                                   np.float64)
    ut = twd.update_wall_distances(tm, [torch.tensor(x) for x in moved], at)
    for a, b, d in zip(uj, ut, dt):
        assert tp.rel(a, b.numpy()) < TOL
        assert tp.rel(d.numpy(), b.numpy()) > 0.0


@pytest.fixture(scope="module")
def euler_pair(tp):
    return tp.overset_pair(tp.OVERSET_MESHES["airfoil_background"][0])


def test_ank_step_matches_jax(euler_pair, tp):
    tp.check_ank_step(euler_pair, "coupled", tp.SHORT)


@pytest.fixture(scope="module")
def updated(tp):
    """Both packages' RANS-SA solvers on the viscous airfoil in its
    background after ``setSurfaceCoordinates`` with a bump and
    ``updateGeometryInfo``, then at the seeded perturbed free stream."""
    js, ts = tp.overset_solvers(
        lambda p: tp.airfoil_background(p, viscous=True), ap=RANS_AP,
        equationType="RANS")
    x0 = [x.clone() for x in ts.x_list]
    pts = bumped(ts.getSurfaceCoordinates(), BUMP)
    for s in (js, ts):
        s.setSurfaceCoordinates(pts)
        s.updateGeometryInfo()
    w0 = tp.perturbed(np.asarray(js._wx_vecs()[0]), ts._newton_packer().nw)
    js.setStates(w0)
    ts.setStates(w0)
    return js, ts, x0


def test_geometry_update_matches_jax(updated, tp):
    js, ts, x0 = updated
    for a, b, c in zip(js.x_list, ts.x_list, x0):
        assert tp.rel(a, b.numpy()) < TOL
        assert float((b - c).abs().max()) > 1e-3
    for a, b in zip(js.extras_list, ts.extras_list):
        assert tp.rel(a["walldist"], b["walldist"].numpy()) < TOL
    assert js.checkOverset(False) == ts.checkOverset(False)
    assert np.allclose(js.getSurfaceCoordinates(),
                       ts.getSurfaceCoordinates(), rtol=0, atol=1e-14)
    # the shape change drops the cached Newton and adjoint functions
    assert ts._afns is None and ts._psi_cache == {}


def test_residual_and_functions_after_update_match_jax(updated, tp):
    import jax

    from adflow_tpu.physics.residual import residual_list as jax_res

    js, ts, _ = updated
    want = jax.jit(lambda w: jax_res(w, js.metrics_list, js.topo, js.cfg,
                                     js.ref, js.winf, js.extras_list))(
        js.w_list)
    got = ts.getResidual(ts.curAP)
    for a, b in zip(want, got):
        assert tp.rel(a, b.numpy()) < STEP_TOL
    fj = js.evalFunctions(js.curAP, {})
    ft = ts.evalFunctions(ts.curAP, {})
    for k in fj:
        assert abs(ft[k] - fj[k]) <= STEP_TOL * abs(fj[k]), k


def test_grid_round_trip(updated, tp):
    js, ts, _ = updated
    g = ts.getGrid()
    assert g.shape == (sum(x.numel() for x in ts.x_list),)
    assert tp.rel(js.getGrid(), g) < TOL
    vol = [m.vol.clone() for m in ts.metrics_list]
    ts.setGrid(g)
    assert np.array_equal(ts.getGrid(), g)
    for a, m in zip(vol, ts.metrics_list):
        assert torch.equal(a, m.vol)
    # setGrid rebuilds the geometry and re-attaches the problem, whose
    # state goes back to the free stream as in the JAX package
    w = ts.getStates().reshape(-1, ts.ref.nw)
    assert torch.equal(w, ts.winf.expand_as(w))


# -- on the card -------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_warp_and_quick_wall_distance_on_card(cuda_device):
    """The viscous airfoil in its background on the card: the f32 warp
    against an f64 warp on the CPU, and the quick wall distance against a
    full search on the card (``chip_smoke.py``'s checks)."""
    import chip_smoke as cs

    solver, _ = cs.small_state(
        "cuda:0", cs.overset_airfoil_mesh(**cs.OVS_SMALL_AIRFOIL,
                                          viscous=True, **cs.OVS_SMALL_BG),
        cs.OVS_SMALL_AP, dict(cs.solver_options(1), useANKSolver=True))
    pts0 = solver.getSurfaceCoordinates()
    new = bumped(pts0, BUMP)
    x0 = [x.clone() for x in solver.x_list]
    solver.setSurfaceCoordinates(new)
    solver.updateGeometryInfo()
    assert cs.check_warp(solver, x0, pts0, new) < cs.WARP_RTOL
    cs.check_quick_walldist(solver)
