"""The port's overset assembly and runtime fill against the JAX package,
float64 on the CPU.

- ``build_overset``: the table (iblank, every group's blocks, priority,
  ``dst_flat``, ``src_flat`` and ``weights``, ``n_orphans``) equal exactly
  for the explicit cut (box in box), the implicit cut (the airfoil in a
  box) and the airfoil in its generated background (orphans); each group's
  receivers distinct, and ``device_table`` refuses a repeated one;
- ``apply_overset`` on the JAX table carried over
  (``interop.overset_table_from_numpy``) and on the port's own, and its
  vjp, to 1e-13; ``fill_halos`` to 1e-13;
- ``residual_list`` with the iblank masks to 1e-12 and its jvp and vjp to
  1e-10, on the box in box (Euler, explicit cut) and the airfoil in its
  background (RANS-SA, implicit cut);
- linear exactness of the fringe interpolation and free-stream
  preservation (both below 1e-11), as tests/test_overset.py states them.

On a card (marker ``cuda``, skipped without one): K1 on both blocks of the
airfoil in its background against the plain route, and K2 on the box in
box, to 1e-5 of the flux scale (a residual at a perturbed state is a
difference of far larger face fluxes). JAX is imported inside the tests that run it, so the card tests run
on a machine without JAX:
``python -m pytest tests/test_torch_overset.py -m cuda --noconftest``.
"""

import dataclasses

import numpy as np
import pytest
import torch

from adflow_torch.overset import assembly as tov

FILL_TOL = 1e-13
RES_TOL = 1e-12
DERIV_TOL = 1e-10
EXACT_TOL = 1e-11


@pytest.fixture(scope="module")
def tp():
    from tests import torch_pairs
    return torch_pairs


@pytest.fixture(scope="module", params=["box_in_box", "airfoil_in_box",
                                        "airfoil_background"])
def tables(request, tp):
    from adflow_tpu.overset import assembly as jov

    fn, cut = tp.OVERSET_MESHES[request.param]
    return (request.param, fn,
            jov.build_overset(fn("adflow_tpu"), cut_callback=cut),
            tov.build_overset(fn("adflow_torch"), cut_callback=cut))


def test_table_matches_jax(tables):
    name, _, want, got = tables
    assert got.n_orphans == want.n_orphans
    assert (got.n_orphans > 0) == (name == "airfoil_background")
    assert len(got.iblank) == len(want.iblank)
    for a, b in zip(want.iblank, got.iblank):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert any((b == tov.IBLANK_FRINGE).any() for b in got.iblank)
    assert len(got.groups) == len(want.groups)
    for g, h in zip(want.groups, got.groups):
        assert (g.dst_block, g.src_block, g.priority) == (
            h.dst_block, h.src_block, h.priority)
        for f in ("dst_flat", "src_flat", "weights"):
            a, b = getattr(g, f), getattr(h, f)
            assert a.dtype == b.dtype and np.array_equal(a, b), f


def test_receivers_distinct(tables):
    """A scatter keeps an arbitrary one of a repeated index's values on
    CUDA, so each group's receivers must be distinct; ``device_table``
    refuses a table that repeats one."""
    _, _, _, got = tables
    for g in got.groups:
        assert len(np.unique(g.dst_flat)) == len(g.dst_flat)
    g = got.groups[0]
    bad = dataclasses.replace(g, dst_flat=np.concatenate(
        [g.dst_flat[:1], g.dst_flat[:-1]]))
    with pytest.raises(ValueError, match="repeats a receiver"):
        tov.device_table(dataclasses.replace(got, groups=(bad,)),
                         torch.float64, "cpu")


def _padded_states(mesh, nv=5, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(tuple(d + 4 for d in b.dims) + (nv,))
            for b in mesh.blocks]


def test_apply_overset_matches_jax(tables):
    import jax
    import jax.numpy as jnp

    from adflow_torch.interop import overset_table_from_numpy
    from adflow_tpu.overset import assembly as jov

    _, fn, want_tab, got_tab = tables
    w = _padded_states(fn("adflow_torch"))
    want = [np.asarray(a) for a in jov.apply_overset(
        [jnp.asarray(a) for a in w], want_tab)]
    wt = [torch.tensor(a) for a in w]
    for tab in (overset_table_from_numpy(want_tab),
                tov.device_table(got_tab, torch.float64, "cpu")):
        got = tov.apply_overset(wt, tab)
        for a, b in zip(want, got):
            assert np.abs(a - b.numpy()).max() <= FILL_TOL * np.abs(a).max()
    # the fill is linear in the donors: its vjp from a seeded cotangent
    cot = _padded_states(fn("adflow_torch"), seed=1)
    vj_j = jax.vjp(lambda *a: jov.apply_overset(list(a), want_tab),
                   *[jnp.asarray(a) for a in w])[1](
        [jnp.asarray(c) for c in cot])
    vj_t = torch.func.vjp(lambda *a: tov.apply_overset(list(a), tab),
                          *wt)[1]([torch.tensor(c) for c in cot])
    for a, b in zip(vj_j, vj_t):
        a = np.asarray(a)
        assert np.abs(a - b.numpy()).max() <= FILL_TOL * np.abs(a).max()


@pytest.fixture(scope="module", params=["box_in_box", "airfoil_background"])
def pair(request, tp):
    if request.param == "box_in_box":
        return request.param, tp.overset_pair(
            lambda p: tp.box_in_box(p, 12, 14), tp.box_cut)
    return request.param, tp.overset_pair(
        lambda p: tp.airfoil_background(p, viscous=True), None,
        ap=dict(name="ov", mach=0.5, alpha=2.0, reynolds=1e6,
                reynoldsLength=1.0, T=300.0, evalFuncs=["cl", "cd"]),
        equationType="RANS")


def test_fill_halos_matches_jax(pair, tp):
    import jax

    from adflow_tpu.physics.residual import fill_halos

    _, p = pair
    js = p.js
    want = jax.jit(lambda w: fill_halos(w, js.metrics_list, js.topo, js.ref,
                                        js.winf))(js.w_list)
    for a, b in zip(want, p.wt):
        assert tp.rel(a, b.numpy()) < FILL_TOL
    assert p.ts.topo.overset is not None
    assert all(bs.iblank is not None for bs in p.ts.topo.blocks)


def test_residual_matches_jax(pair, tp):
    import jax

    name, p = pair
    want = np.asarray(jax.jit(p.jf.res_flat)(p.w0))
    got = p.tf.res_flat(torch.from_numpy(p.w0)).numpy()
    assert tp.rel(want, got) < RES_TOL
    # the fringe and hole rows are zero
    rows = got.reshape(-1, p.tf.packer.nw)
    masks = np.concatenate([bs.iblank.numpy().reshape(-1)
                            for bs in p.ts.topo.blocks])
    assert np.all(rows[masks == 0.0] == 0.0)
    assert (masks == 0.0).any()


def test_residual_derivatives_match_jax(pair, tp):
    _, p = pair
    tp.check_flat_derivatives(p, tol=DERIV_TOL)


def test_linear_exactness(tp):
    """Trilinear donors reproduce a linear field exactly at every
    interpolated receiver (the inner box's ghosts and the background's
    fringe), poisoned beforehand."""
    mesh = tp.box_in_box("adflow_torch")
    tab = tov.build_overset(mesh, cut_callback=tp.box_cut)
    assert tab.n_orphans == 0

    def lin(c):
        return 1.0 + 2.0 * c[..., 0] - 3.0 * c[..., 1] + 0.5 * c[..., 2]

    exact = [lin(tov._padded_centers(b.x))[..., None] for b in mesh.blocks]
    w0, w1 = exact[0].copy(), exact[1].copy()
    w1[:2], w1[-2:], w1[:, :2], w1[:, -2:] = 99.0, 99.0, 99.0, 99.0
    w1[:, :, :2], w1[:, :, -2:] = 99.0, 99.0
    fr = tab.iblank[0] == tov.IBLANK_FRINGE
    w0[2:-2, 2:-2, 2:-2][fr] = 99.0
    out = tov.apply_overset([torch.tensor(w0), torch.tensor(w1)],
                            tov.device_table(tab, torch.float64, "cpu"))
    err_in = np.abs(out[1].numpy() - exact[1])
    assert err_in[:2, 2:-2, 2:-2].max() < EXACT_TOL
    assert err_in[-2:, 2:-2, 2:-2].max() < EXACT_TOL
    err_bg = np.abs(out[0].numpy() - exact[0])[2:-2, 2:-2, 2:-2]
    assert err_bg[fr].max() < EXACT_TOL


@pytest.mark.parametrize("case", ["box_in_box", "airfoil_in_box"])
def test_freestream_preserved(case, tp):
    """The free stream through the whole overset residual (holes, fringes,
    interpolation): the background exactly; the airfoil away from its wall
    rows (a wall deflects uniform flow)."""
    from adflow_torch.core.refstate import AeroProblem, make_reference_state
    from adflow_torch.geom.metrics import compute_metrics
    from adflow_torch.physics.residual import (
        ProblemConfig, build_topology, residual_list)

    fn, cut = tp.OVERSET_MESHES[case]
    mesh = (tp.box_in_box("adflow_torch", 12, 14) if case == "box_in_box"
            else fn("adflow_torch"))
    topo = build_topology(mesh, cut_callback=cut)
    assert topo.overset is not None
    cfg = ProblemConfig(equation_type="euler", vis2=0.25, vis4=1 / 64.0,
                        diss_exponent=0.67)
    ref = make_reference_state(AeroProblem(name="fs", mach=0.5, alpha=3.0),
                               lift_index=2, n_turb=0)
    winf = torch.tensor(ref.winf())
    metrics = [compute_metrics(torch.tensor(b.x)) for b in mesh.blocks]
    w = [winf.expand(tuple(d + 4 for d in b.dims) + (5,)).clone()
         for b in mesh.blocks]
    r = residual_list(w, metrics, topo, cfg, ref, winf)
    if case == "box_in_box":
        assert max(float(rb.abs().max()) for rb in r) < EXACT_TOL
    else:
        assert float(r[1].abs().max()) < EXACT_TOL
        assert float(r[0][:, 2:].abs().max()) < EXACT_TOL


# -- on the card -------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda", 0)


def _check_against_plain_route(mesh_fn, ap, options, want, cut=None):
    """The residual of every block on the card through the kernels against
    the plain route (``useBlockettes: False``), both f32, from the same
    seeded perturbed state, iblank applied: to FLUX_RTOL of the flux scale
    (``chip_smoke.residual_scale``), with the launches ``want``."""
    import chip_smoke as cs

    kw = {} if cut is None else {"cutCallback": cut}
    card, w0 = cs.small_state("cuda:0", mesh_fn(), ap, options, **kw)
    plain, _ = cs.small_state("cuda:0", mesh_fn(), ap,
                              dict(options, useBlockettes=False), w0, **kw)
    cs.zero_launches()
    got = card.getResidual(card.curAP)
    assert cs.launches() == want
    for i, (a, b) in enumerate(zip(plain.getResidual(plain.curAP), got)):
        assert bool(torch.isfinite(b).all())
        err = (a - b).abs().amax(dim=(0, 1, 2)) / cs.residual_scale(
            plain, i, a)
        assert float(err.max()) < cs.FLUX_RTOL


@pytest.mark.cuda
def test_k1_on_overset_airfoil_matches_plain_route(cuda_device):
    """K1 on both blocks of the RANS-SA airfoil in its background, one
    launch a block."""
    import chip_smoke as cs

    _check_against_plain_route(
        lambda: cs.overset_airfoil_mesh(**cs.OVS_SMALL_AIRFOIL, viscous=True,
                                        **cs.OVS_SMALL_BG),
        cs.OVS_SMALL_AP, dict(cs.solver_options(1), useANKSolver=True),
        (2, 0))


@pytest.mark.cuda
def test_k2_on_box_in_box_matches_plain_route(cuda_device):
    """K2 on both blocks of the box in box under its explicit cut."""
    import chip_smoke as cs

    _check_against_plain_route(
        cs.box_in_box_mesh, dict(cs.OVS_SMALL_AP, name="bb"),
        cs.euler_options(1), (0, 2), cut=cs.box_cut)
