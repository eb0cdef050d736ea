"""The port's overset surface integration against the JAX package, float64
on the CPU: the overlap weights (``overlap_surface_weights``) and the
zipper's gap triangles (``build_zipper_gaps``) equal exactly on
tests/test_zipper.py's two-patch and touching meshes, and watertight; and
``integrate_forces`` with the weights, the gap triangles and iblank masks
(seeded 0/1 masks on every cell) and ``wall_sensors`` with the masks, at
the seeded perturbed free stream of a laminar solve, to 1e-12."""

import numpy as np
import pytest
import torch

from adflow_torch.overset import assembly as tov

TOL = 1e-12


@pytest.fixture(scope="module")
def tp():
    from tests import torch_pairs
    return torch_pairs


def _surface(package, mesh):
    import importlib

    asm = importlib.import_module(f"{package}.overset.assembly")
    surf = importlib.import_module(f"{package}.physics.surface")
    patches = surf.build_wall_patches(mesh)
    weights = asm.overlap_surface_weights(mesh, patches)
    return patches, weights, asm.build_zipper_gaps(mesh, patches, weights)


@pytest.mark.parametrize("overlap", [0.2, 0.0], ids=["overlap", "touching"])
def test_weights_and_gaps_match_jax(tp, overlap):
    want = _surface("adflow_tpu", tp.two_patch_mesh("adflow_tpu", overlap))
    mesh = tp.two_patch_mesh("adflow_torch", overlap)
    got = _surface("adflow_torch", mesh)
    assert len(got[1]) == len(want[1])
    for a, b in zip(want[1], got[1]):
        assert (a is None) == (b is None)
        if a is not None:
            assert np.array_equal(a, b)
    assert (want[2] is None) == (got[2] is None)
    if got[2] is not None:
        for f in ("patch_idx", "face_flat", "svec", "centroid"):
            assert np.array_equal(getattr(want[2], f), getattr(got[2], f)), f
    # watertight: the weighted faces and the gap triangles cover [0,1]^2
    area = 0.0
    for p, w in zip(got[0], got[1]):
        xs = mesh.blocks[p.block].x[p.fnode_sl]
        a = 0.5 * np.linalg.norm(np.cross(xs[1:, 1:] - xs[:-1, :-1],
                                          xs[:-1, 1:] - xs[1:, :-1]), axis=-1)
        area += float(np.sum(a if w is None else a * w))
    if got[2] is not None:
        area += float(np.linalg.norm(got[2].svec, axis=1).sum())
    assert abs(area - 1.0) < 1e-3
    if overlap:
        assert got[2].n_tris > 0


@pytest.fixture(scope="module")
def lam(tp):
    """Both packages' laminar solvers on the two-patch mesh at the seeded
    perturbed free stream, their filled states, the port's weights and
    gaps, and seeded 0/1 iblank masks."""
    js, ts = tp.overset_solvers(
        lambda p: tp.two_patch_mesh(p), None,
        ap=dict(name="zp", mach=0.5, alpha=3.0, reynolds=1e5,
                reynoldsLength=1.0, T=300.0), equationType="laminar NS")
    w0 = tp.perturbed(np.asarray(js._wx_vecs()[0]), 5)
    js.setStates(w0)
    ts.setStates(w0)
    _, weights, gaps = _surface("adflow_torch", ts.mesh)
    rng = np.random.default_rng(2)
    masks = [(rng.random(b.dims + (1,)) > 0.3).astype(float)
             for b in ts.mesh.blocks]
    return js, ts, weights, gaps, masks


def test_integrate_forces_matches_jax(lam, tp):
    import jax
    import jax.numpy as jnp

    from adflow_torch.physics.surface import integrate_forces
    from adflow_tpu.physics.surface import integrate_forces as jax_forces

    js, ts, weights, gaps, masks = lam
    want = jax.jit(lambda w: jax_forces(
        w, js.x_list, js.metrics_list, js.wall_patches, js.ref, js.cfg,
        iblank_list=[jnp.asarray(m) for m in masks],
        extras_list=js.extras_list, patch_weights=weights,
        zipper=gaps))(js._filled_w())
    for ibl in (None, [torch.tensor(m) for m in masks]):
        got = integrate_forces(
            ts._filled_w(), ts.x_list, ts.metrics_list, ts.wall_patches,
            ts.ref, ts.cfg, iblank_list=ibl, extras_list=ts.extras_list,
            patch_weights=weights, zipper=gaps)
        assert set(got) == set(want)
        err = max(tp.rel(want[k], got[k].numpy()) for k in want)
        assert (err < TOL) == (ibl is not None), err
    assert float(np.abs(np.asarray(want["force_v"])).max()) > 0.0


def test_wall_sensors_match_jax(lam, tp):
    import jax
    import jax.numpy as jnp

    from adflow_torch.physics.surface import wall_sensors
    from adflow_tpu.physics.surface import wall_sensors as jax_sensors

    js, ts, _, _, masks = lam
    want = jax.jit(lambda w: jax_sensors(
        w, js.metrics_list, js.wall_patches, js.ref,
        iblank_list=[jnp.asarray(m) for m in masks],
        x_list=js.x_list))(js._filled_w())
    got = wall_sensors(ts._filled_w(), ts.metrics_list, ts.wall_patches,
                       ts.ref, iblank_list=[torch.tensor(m) for m in masks],
                       x_list=ts.x_list)
    assert set(got) == set(want)
    for k in want:
        assert tp.rel(want[k], got[k].numpy()) < TOL, k
