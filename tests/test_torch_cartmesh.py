"""The port's Cartesian background generator (``meshgen/cartmesh.py``)
against the JAX package's: the node arrays equal exactly and the same
faces and BCs, for the JAX package's own cases (tests/test_cartmesh.py)
and for the overset airfoils of the port's tests and of ``chip_smoke.py``
[26]; the quirk of its symmetry clip (inverted cells where the core's
spacing is below the margin) kept, and refused by both packages'
``ADFLOW``."""

import numpy as np
import pytest

CASES = {
    # (near-body generator, its keywords, cartesian_background's keywords)
    "cube_default": ("cube_mesh", dict(n=4), dict()),
    "airfoil_sym": ("naca0012_omesh", dict(ni=40, nj=10, nk=2, radius=1.2),
                    dict(scale=4.0, far=6.0, sym_planes=("zlow", "zhigh"))),
    "airfoil_one_sym": ("naca0012_omesh", dict(ni=32, nj=8, nk=2),
                        dict(scale=3.0, margin=0.5, stretch=1.3,
                             sym_planes=("zlow",))),
    "airfoil_full_width": ("naca0012_omesh",
                           dict(ni=256, nj=64, nk=64, radius=1.5,
                                viscous=True),
                           dict(scale=1.25, margin=0.0,
                                sym_planes=("zlow", "zhigh"))),
}


def _near(package, fn, kw):
    import importlib

    an = importlib.import_module(f"{package}.meshgen.analytic")
    mesh = getattr(an, fn)(**kw)
    if fn == "cube_mesh":
        # a wall on the cube's zmin face, as tests/test_cartmesh.py has it
        m = importlib.import_module(f"{package}.core.mesh")
        blk = mesh.blocks[0]
        blk.bcs = [sf for sf in blk.bcs if sf.face is not m.Face.KMIN] + [
            m.BCSubface(m.Face.KMIN, m.BCType.EULER_WALL, family="wall")]
    return mesh


def _background(package, case):
    import importlib

    fn, kw, bg = CASES[case]
    cm = importlib.import_module(f"{package}.meshgen.cartmesh")
    return cm.cartesian_background(_near(package, fn, kw), **bg)


@pytest.mark.parametrize("case", sorted(CASES))
def test_background_matches_jax(case):
    want = _background("adflow_tpu", case)
    got = _background("adflow_torch", case)
    assert got.name == want.name
    assert len(got.blocks) == len(want.blocks)
    for a, b in zip(want.blocks, got.blocks):
        assert a.name == b.name
        assert a.x.shape == b.x.shape and np.array_equal(a.x, b.x)
        assert [(int(sf.face), sf.bc.value, sf.family) for sf in a.bcs] == \
            [(int(sf.face), sf.bc.value, sf.family) for sf in b.bcs]
    if case == "airfoil_full_width":
        assert got.blocks[1].dims == (130, 67, 72)


def test_symmetry_clip_inverts_cells_in_both():
    """With symmetry planes, the clip keeps the core's nodes between its
    start (the margin below the body) and the body's bounding-box face: at
    the default margin and a spacing below it, the first cells invert. The
    port keeps the JAX package's nodes, and both solvers refuse the mesh."""
    from adflow_torch.api.solver import ADFLOW
    from adflow_torch.geom.quality import check_mesh_quality

    kw = dict(scale=2.5, sym_planes=("zlow", "zhigh"))
    near = ("naca0012_omesh", dict(ni=40, nj=10, nk=2, radius=1.2))
    meshes = {}
    for package in ("adflow_tpu", "adflow_torch"):
        import importlib

        cm = importlib.import_module(f"{package}.meshgen.cartmesh")
        meshes[package] = cm.cartesian_background(
            _near(package, *near), **kw)
    a, b = (m.blocks[1].x for m in meshes.values())
    assert np.array_equal(a, b)
    assert (np.diff(b[0, 0, :, 2]) < 0.0).any()
    assert check_mesh_quality(meshes["adflow_torch"])["n_negative_volumes"]
    with pytest.raises(ValueError, match="non-positive cell volume"):
        ADFLOW(options={"equationType": "euler"},
               mesh=meshes["adflow_torch"], device="cpu")
