"""The port's forces, BC data and extra functions against the JAX package,
float64 on the CPU, at the seeded perturbed free stream of each case:

- ``getForces`` and ``getHeatFluxes`` to 1e-12 (the viscous plate and the
  Euler wing), the nodal forces summing to ``fx``, ``fy``, ``fz``
  (tests/test_io_functions.py::test_nodal_forces_sum) and the force file
  equal to round-off;
- the extended cost functions of test_io_functions.py and the family and
  user functions of tests/test_api_extras.py, to 1e-12;
- ``setBCVar``/``getBCData`` on the two-inflow duct of
  tests/test_multiple_bc.py at one residual evaluation, to 1e-12 of the
  flux scale; after ``setBCVar`` the port's Jacobian-vector product is the
  freshly built solver's (slow: the JAX package keeps the old one,
  ROADMAP.md section 3, deliberate differences);
- ``setWallTemperature`` on an isothermal plate;
- ``mapVector`` exactly.
"""

import dataclasses
import importlib

import numpy as np
import pytest
import torch

from tests import torch_pairs

TOL = 1e-12


def state_pair(case, **options):
    js, ts = torch_pairs.solvers(case, **options)
    w0 = torch_pairs.perturbed(np.asarray(js.getStates()), ts.ref.nw)
    js.setStates(w0)
    ts.setStates(w0)
    return js, ts


def close(got, want, tol=TOL):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * max(np.abs(want).max(), 1e-300))


@pytest.fixture(scope="module")
def plate():
    return state_pair("rans_plate")


@pytest.fixture(scope="module")
def wing():
    return state_pair("euler_wing")


@pytest.mark.parametrize("case", ["plate", "wing"])
def test_forces_and_heat_fluxes(case, request):
    js, ts = request.getfixturevalue(case)
    fj, ft = js.getForces(), ts.getForces()
    assert isinstance(ft, np.ndarray) and ft.shape == np.shape(fj)
    close(ft, fj)
    close(ts.getHeatFluxes(), js.getHeatFluxes())


def test_nodal_forces_sum(wing):
    js, ts = wing
    ap = ts.curAP
    funcs = ts.evalFunctions(ap, {}, evalFuncs=["fx", "fy", "fz"])
    want = [funcs[f"{ap.name}_{k}"] for k in ("fx", "fy", "fz")]
    f = ts.getForces()
    np.testing.assert_allclose(f.sum(axis=0), want, rtol=0,
                               atol=1e-10 * np.abs(want).max())


def test_force_file(wing, tmp_path):
    js, ts = wing
    pj, pt = str(tmp_path / "j.txt"), str(tmp_path / "t.txt")
    js.writeForceFile(pj)
    ts.writeForceFile(pt)
    lj, lt = open(pj).readlines(), open(pt).readlines()
    assert lj[0] == lt[0] and len(lj) == len(lt)
    close(np.loadtxt(pt, skiprows=1), np.loadtxt(pj, skiprows=1))


FUNCS = ["cl", "clp", "clv", "sepsensor", "cavitation", "area", "cmx", "cfy",
         "cd", "fx", "fy", "fz", "lift", "drag"]


@pytest.mark.parametrize("case", ["plate", "wing"])
def test_extended_cost_functions(case, request):
    js, ts = request.getfixturevalue(case)
    fj = js.evalFunctions(js.curAP, {}, evalFuncs=FUNCS)
    ft = ts.evalFunctions(ts.curAP, {}, evalFuncs=FUNCS)
    assert sorted(fj) == sorted(ft)
    for k in fj:
        assert abs(ft[k] - fj[k]) <= TOL * max(abs(fj[k]), 1e-12), k
    if case == "wing":
        name = ts.curAP.name
        assert ft[f"{name}_clv"] == 0.0
        assert abs(ft[f"{name}_clp"] - ft[f"{name}_cl"]) <= 1e-12


def test_user_and_family_functions(wing):
    """A user composite and a family-restricted function (the wing's one
    family: equal to the unrestricted one)."""
    out = []
    for s in wing:
        s.addUserFunction("clsq", ["cl"], lambda f: f["cl"] ** 2)
        name = s.addFunction("cd", "wall")
        s.addFunction("cl", "wall", name="cl_w")
        out.append(s.evalFunctions(
            s.curAP, {}, evalFuncs=["cl", "cd", "clsq", name, "cl_w"]))
        s._extra_funcs = {}
    fj, ft = out
    assert sorted(fj) == sorted(ft)
    for k in fj:
        assert abs(ft[k] - fj[k]) <= TOL * abs(fj[k]), k
    n = "w"
    assert ft[f"{n}_clsq"] == pytest.approx(ft[f"{n}_cl"] ** 2, rel=1e-14)
    assert ft[f"{n}_cd_wall"] == pytest.approx(ft[f"{n}_cd"], rel=1e-12)
    assert ft[f"{n}_cl_w"] == pytest.approx(ft[f"{n}_cl"], rel=1e-12)


# -- BC data -----------------------------------------------------------------

def two_inflow_channel(package, ni=16, nj=8, nk=2):
    """The duct of tests/test_multiple_bc.py: the inflow face split into
    two families, lower and upper half."""
    meshmod = importlib.import_module(f"{package}.core.mesh")
    gen = importlib.import_module(f"{package}.meshgen.analytic")
    b = gen.channel_mesh(ni=ni, nj=nj, nk=nk, width=0.5).blocks[0]
    bcs = []
    for sf in b.bcs:
        if sf.face is meshmod.Face.IMIN:
            for fam, rng in (("inflow1", (0, nj // 2)),
                             ("inflow2", (nj // 2, nj))):
                bcs.append(meshmod.BCSubface(
                    meshmod.Face.IMIN, meshmod.BCType.SUBSONIC_INFLOW,
                    family=fam, rng=(rng, (0, nk))))
        else:
            bcs.append(sf)
    return meshmod.MultiBlockMesh(
        [meshmod.Block("duct", b.x, bcs, b.conns)], name="duct")


def duct(package, device=None):
    api = importlib.import_module(f"{package}.api.solver")
    ref = importlib.import_module(f"{package}.core.refstate")
    kw = {} if device is None else {"device": device}
    s = api.ADFLOW(options={"equationType": "euler", **torch_pairs.QUIET},
                   mesh=two_inflow_channel(package), **kw)
    s.setAeroProblem(ref.AeroProblem(name="duct", mach=0.3, alpha=0.0))
    return s


def set_duct_bcs(s):
    """The BC data of test_multi_family_bc_data_solve, with a pressure
    profile over the outflow face."""
    m, pinf = 0.3, s.ref.p_inf
    pt = pinf * (1 + 0.2 * m ** 2) ** 3.5
    tt = 1.0 + 0.2 * m ** 2
    s.setBCVar("PressureStagnation", pt * 1.04, "inflow1")
    s.setBCVar("PressureStagnation", pt * 1.01, "inflow2")
    s.setBCVar("TemperatureStagnation", tt * 1.05, "inflow1")
    s.setBCVar("TemperatureStagnation", tt, "inflow2")
    s.setBCVar("Pressure", pinf * (1.0 + 0.02 * np.linspace(-1, 1, 8))[:, None]
               * np.ones((1, 2)), "outflow")


@pytest.fixture(scope="module")
def ducts():
    js, ts = duct("adflow_tpu"), duct("adflow_torch", "cpu")
    w0 = torch_pairs.perturbed(np.asarray(js.getStates()), 5)
    for s in (js, ts):
        s.setStates(w0)
    return js, ts, w0


def test_set_bc_var_residual(ducts):
    js, ts, _ = ducts
    before = ts.getResidual(ts.curAP)[0].numpy()
    for s in (js, ts):
        set_duct_bcs(s)
    dj, dt = js.getBCData(), ts.getBCData()
    assert sorted(dj) == sorted(dt) == ["inflow1", "inflow2", "outflow"]
    for fam in dj:
        assert sorted(dj[fam]) == sorted(dt[fam])
        for k in dj[fam]:
            assert np.array_equal(dt[fam][k], dj[fam][k]), (fam, k)
    assert ts.getBCData("outflow").keys() == {"outflow"}
    rj = np.asarray(js.getResidual(js.curAP)[0])
    rt = ts.getResidual(ts.curAP)[0].numpy()
    scale = torch_pairs.flux_scale(ts._filled_w()[0], ts.metrics_list[0])
    np.testing.assert_allclose(rt, rj, rtol=0, atol=TOL * scale)
    assert np.abs(rt - before).max() > 1e-6 * scale
    with pytest.raises(ValueError, match="unknown BC variable"):
        ts.setBCVar("Swirl", 1.0, "outflow")
    with pytest.raises(ValueError, match="no BC subfaces"):
        ts.setBCVar("Pressure", 1.0, "nowhere")


def _jvp_after_and_fresh(package, device, w0, v):
    """``computeJacobianVectorProductFwd`` after ``setBCVar`` and that of a
    solver built with the new BC data."""
    out = []
    for fresh in (False, True):
        s = duct(package, device)
        if fresh:
            set_duct_bcs(s)
        s.setStates(w0)
        s.computeJacobianVectorProductFwd(wDot=v, residualDeriv=True)
        if not fresh:
            set_duct_bcs(s)
        out.append(np.asarray(s.computeJacobianVectorProductFwd(
            wDot=v, residualDeriv=True)))
    return out


def test_set_bc_var_drops_the_linearization(ducts):
    """After ``setBCVar`` the port's ``computeJacobianVectorProductFwd`` is
    that of a solver built with the new BC data (the JAX package's is not:
    the slow case below)."""
    _, _, w0 = ducts
    v = np.random.default_rng(1).standard_normal(w0.shape)
    after, fresh = _jvp_after_and_fresh("adflow_torch", "cpu", w0, v)
    close(after, fresh)


@pytest.mark.slow
def test_set_bc_var_jax_keeps_the_old_linearization(ducts):
    """The JAX package's jvp after ``setBCVar`` is still that of the old
    BC data (ROADMAP.md section 3); its fresh solver's equals the port's."""
    _, _, w0 = ducts
    v = np.random.default_rng(1).standard_normal(w0.shape)
    jax_after, jax_fresh = _jvp_after_and_fresh("adflow_tpu", None, w0, v)
    _, fresh = _jvp_after_and_fresh("adflow_torch", "cpu", w0, v)
    close(fresh, jax_fresh)
    assert np.abs(jax_after - jax_fresh).max() > 1e-3 * np.abs(
        jax_fresh).max()


def test_set_wall_temperature():
    """An isothermal plate: ``setWallTemperature`` changes the wall
    datum, and the residual after it matches the JAX package's."""
    out = []
    for package, device in (("adflow_tpu", None), ("adflow_torch", "cpu")):
        meshmod = importlib.import_module(f"{package}.core.mesh")
        gen = importlib.import_module(f"{package}.meshgen.analytic")
        api = importlib.import_module(f"{package}.api.solver")
        ref = importlib.import_module(f"{package}.core.refstate")
        b = gen.flatplate_mesh(ni=16, nj=12).blocks[0]
        bcs = [dataclasses.replace(sf, bc=meshmod.BCType.NS_WALL_ISOTHERMAL,
                                   data={"T": 300.0})
               if sf.bc is meshmod.BCType.NS_WALL_ADIABATIC else sf
               for sf in b.bcs]
        mesh = meshmod.MultiBlockMesh([meshmod.Block(b.name, b.x, bcs,
                                                     b.conns)])
        kw = {} if device is None else {"device": device}
        s = api.ADFLOW(options={"equationType": "laminar NS",
                                **torch_pairs.QUIET}, mesh=mesh, **kw)
        s.setAeroProblem(ref.AeroProblem(name="fp", mach=0.3, alpha=0.0,
                                         reynolds=1e4, reynoldsLength=1.0,
                                         T=300.0))
        if not out:
            w0 = torch_pairs.perturbed(np.asarray(s.getStates()), 5)
        s.setStates(w0)
        r0 = np.asarray(s.getResidual(s.curAP)[0])
        s.setWallTemperature(330.0)
        fams = {sf.family for sf in mesh.blocks[0].bcs
                if sf.bc is meshmod.BCType.NS_WALL_ISOTHERMAL}
        assert all(d["T"] == 330.0 for f, d in s.getBCData().items()
                   if f in fams)
        out.append((r0, np.asarray(s.getResidual(s.curAP)[0]),
                    s._filled_w()[0], s.metrics_list[0]))
    (rj0, rj, *_), (rt0, rt, wt, mt) = out
    scale = torch_pairs.flux_scale(wt, mt)
    np.testing.assert_allclose(rt0, rj0, rtol=0, atol=TOL * scale)
    np.testing.assert_allclose(rt, rj, rtol=0, atol=TOL * scale)
    assert np.abs(rt - rt0).max() > 1e-6 * scale


def test_map_vector(ducts):
    """Between the duct's two wall families and all walls, exactly; the
    result also written into a numpy array and into a tensor."""
    js, ts, _ = ducts
    n = ts.getSurfaceCoordinates().shape[0]
    v = np.arange(n * 3, dtype=float).reshape(-1, 3)
    for g1, g2 in ((None, None), (None, "lower_wall"),
                   ("upper_wall", None), ("lower_wall", "lower_wall")):
        src = v if g1 is None else js.mapVector(v, None, g1)
        want = js.mapVector(src, g1, g2)
        got = ts.mapVector(src, g1, g2)
        assert np.array_equal(got, want), (g1, g2)
        into = np.zeros_like(got)
        ts.mapVector(src, g1, g2, vec2=into)
        assert np.array_equal(into, want)
        into_t = torch.zeros(got.shape, dtype=torch.float64)
        ts.mapVector(torch.as_tensor(src), g1, g2, vec2=into_t)
        assert np.array_equal(into_t.numpy(), want)
    assert np.array_equal(ts.mapVector(v, None, None), v)
