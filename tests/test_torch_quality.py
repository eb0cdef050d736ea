"""The port's mesh-quality check (``geom/quality.py``) and the solver's
diagnostics against the JAX package, float64 on the CPU: ``cell_quality``'s
arrays and ``check_mesh_quality``'s report equal, on a uniform, a sheared,
an inverted and a twisted cube (tests/test_quality.py's cases), the wing
O-mesh and the overset airfoil in its background; ``checkMeshQuality``
and ``checkOverset`` through ``ADFLOW`` equal, before and after a warp."""

import numpy as np
import pytest


def _cube_case(package, case):
    import importlib

    mesh = importlib.import_module(f"{package}.meshgen.analytic").cube_mesh(
        n=2 if case == "twisted" else 4)
    x = mesh.blocks[0].x.copy()
    if case == "sheared":
        x[..., 0] += 0.5 * x[..., 1]
    elif case == "inverted":
        x[2, 2, 2] = x[1, 1, 1] - 0.3 * (x[3, 3, 3] - x[1, 1, 1])
    elif case == "twisted":
        top = x[1:3, 1:3, 2].copy()
        x[1, 1, 2], x[1, 2, 2] = top[0, 1], top[1, 1]
        x[2, 2, 2], x[2, 1, 2] = top[1, 0], top[0, 0]
    mesh.blocks[0].x = x
    return mesh


def _mesh(package, case):
    import importlib

    if case == "wing":
        return importlib.import_module(
            f"{package}.meshgen.analytic").wing_omesh(16, 8, 8, viscous=True)
    if case == "overset airfoil":
        from tests.torch_pairs import airfoil_background
        return airfoil_background(package, viscous=True)
    return _cube_case(package, case)


@pytest.mark.parametrize("case", ["uniform", "sheared", "inverted",
                                  "twisted", "wing", "overset airfoil"])
def test_quality_matches_jax(case):
    from adflow_torch.geom.quality import cell_quality, check_mesh_quality
    from adflow_tpu.geom.quality import cell_quality as jax_cells
    from adflow_tpu.geom.quality import check_mesh_quality as jax_check

    jm, tm = _mesh("adflow_tpu", case), _mesh("adflow_torch", case)
    want, got = jax_check(jm), check_mesh_quality(tm)
    assert got == want
    assert got["ok"] == (case not in ("inverted", "twisted"))
    for a, b in zip(jm.blocks, tm.blocks):
        qa, qb = jax_cells(a.x), cell_quality(b.x)
        assert set(qa) == set(qb)
        for k in qa:
            assert np.array_equal(qa[k], qb[k]), k


def test_solver_diagnostics_match_jax():
    """``checkMeshQuality`` and ``checkOverset`` of both solvers on the
    viscous airfoil in its background, at construction and after a warp
    of its upper surface."""
    from tests.torch_pairs import airfoil_background, overset_solvers

    js, ts = overset_solvers(lambda p: airfoil_background(p, viscous=True))
    for step in range(2):
        assert ts.checkMeshQuality(warn=False) == \
            js.checkMeshQuality(warn=False)
        rep = ts.checkOverset(printReport=False)
        assert rep == js.checkOverset(printReport=False)
        assert rep["hole"] > 0 and rep["fringe"] > 0 and rep["orphans"] > 0
        assert rep["compute"] + rep["fringe"] + rep["hole"] == rep["n_cells"]
        if step == 0:
            pts = ts.getSurfaceCoordinates()
            pts[:, 1] += np.where(pts[:, 1] > 0, 0.01, 0.0)
            for s in (js, ts):
                s.setSurfaceCoordinates(pts)
                s.updateGeometryInfo()
