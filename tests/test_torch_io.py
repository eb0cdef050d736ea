"""The port's mesh and solution files and restart against the JAX package,
float64 on the CPU:

- the ADF cases of tests/test_adf.py with the port's copies;
- CGNS mesh files written by either package and read by the other, in
  both flavours: coordinates bitwise, BCs, families and connections field
  by field; the port's ADF-flavour writer (used where h5py is absent);
- ``_solution_dicts`` with every variable of the volume menu to 1e-12, and
  solution files written by either package read equal in the other;
- ``gridFile`` through ``.cgns`` (both flavours), ``.npz`` and plot3d;
- a ``.npz`` written by the JAX package read by the port in a process that
  never imports the JAX package or JAX;
- the write-and-restart round trip of tests/test_io_functions.py on both
  packages, the port's restarted state equal to the JAX package's to
  1e-14, and float32 restart bitwise;
- ``getConvergenceHistory`` equal after the same 25 RK cycles.
"""

import dataclasses
import enum
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import adflow_torch.meshgen.analytic as tmeshgen
import adflow_tpu.meshgen.analytic as jmeshgen
from adflow_torch.api.solver import ADFLOW
from adflow_torch.core.refstate import AeroProblem
from adflow_torch.io import adf as tadf
from adflow_torch.io import cgns as tcgns
from adflow_torch.io import meshio as tmeshio
from adflow_tpu.api.solver import ADFLOW as JaxADFLOW
from adflow_tpu.core.refstate import AeroProblem as JaxAP
from adflow_tpu.io import cgns as jcgns
from adflow_tpu.io import meshio as jmeshio

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-12
RK = {"equationType": "euler", "useANKSolver": False, "useNKSolver": False,
      "nCycles": 25, "printIterations": False, "printTiming": False}


def _fields(obj):
    """A dataclass's fields with enums as their values and arrays as
    lists, for comparing the two packages' mesh objects."""
    def norm(v):
        if isinstance(v, enum.Enum):
            return v.value
        if isinstance(v, np.ndarray):
            return v.tolist()
        if isinstance(v, dict):
            return {k: norm(x) for k, x in v.items()}
        if isinstance(v, (tuple, list)):
            return type(v)(norm(x) for x in v)
        return v
    return {f.name: norm(getattr(obj, f.name))
            for f in dataclasses.fields(obj)}


def _bc_fields(sf, dims):
    """A BC subface's fields, its range None where it covers the whole
    face (as the CGNS reader gives it)."""
    d = _fields(sf)
    t1, t2 = [dims[a] for a in range(3) if a != sf.face.axis]
    if d["rng"] == ((0, t1), (0, t2)):
        d["rng"] = None
    return d


def assert_mesh_equal(a, b):
    assert len(a.blocks) == len(b.blocks)
    for ba, bb in zip(a.blocks, b.blocks):
        assert ba.name == bb.name
        assert ba.x.dtype == bb.x.dtype and np.array_equal(ba.x, bb.x)
        assert ([_bc_fields(s, ba.dims) for s in ba.bcs]
                == [_bc_fields(s, bb.dims) for s in bb.bcs])
        assert ([_fields(c) for c in ba.conns]
                == [_fields(c) for c in bb.conns])


def _two_block_mesh(tmp_path):
    """The JAX tests' two-block cube (split_block), as both packages'
    mesh objects: the port's read from the JAX package's ``.npz``."""
    from adflow_tpu.dist.stacked import split_block
    jm = split_block(jmeshgen.cube_mesh(n=4), 0, 0, 2)
    p = str(tmp_path / "two.npz")
    jmeshio.write_npz(jm, p)
    return jm, tmeshio.read_npz(p)


# -- the ADF cases of tests/test_adf.py ------------------------------------

def test_adf_tree_roundtrip(tmp_path):
    root = tadf.AdfNode("ADF MotherNode", "Root Node of ADF File", "MT", (),
                        None)
    base = root.add_child(tadf.AdfNode("Base", "CGNSBase_t", "I4", (),
                                       np.array([3, 3], np.int32)))
    arr = np.arange(24, dtype=np.float64).reshape(2, 3, 4)
    base.add_child(tadf.AdfNode("Coords", "DataArray_t", "R8", (), arr))
    base.add_child(tadf.AdfNode("Note", "Descriptor_t", "C1", (),
                                np.frombuffer(b"hello adf", np.int8)))
    p = str(tmp_path / "t.adf")
    tadf.write_adf_tree(root, p)
    assert tadf.is_adf(p)
    r = tadf.read_adf_tree(p)
    assert r.name == "ADF MotherNode"
    b = r["Base"]
    assert b.label == "CGNSBase_t"
    np.testing.assert_array_equal(np.asarray(b[" data"]),
                                  np.array([3, 3], np.int32))
    np.testing.assert_array_equal(np.asarray(b["Coords"][" data"]), arr)
    assert np.asarray(b["Note"][" data"]).tobytes() == b"hello adf"


def test_adf_cgns_mesh_roundtrip(tmp_path):
    _, mesh = _two_block_mesh(tmp_path)
    h5 = str(tmp_path / "m.cgns")
    adf = str(tmp_path / "m_adf.cgns")
    tcgns.write_cgns(mesh, h5)
    tadf.hdf5_to_adf(h5, adf)
    assert tadf.is_adf(adf) and not tadf.is_adf(h5)
    assert_mesh_equal(tcgns.read_cgns(h5), tcgns.read_cgns(adf))


def test_adf_solution_read(tmp_path):
    mesh = tmeshgen.naca0012_omesh(ni=16, nj=8)
    ni, nj, nk = mesh.blocks[0].dims
    rng = np.random.default_rng(7)
    sol = {"Density": rng.random((ni, nj, nk)),
           "Pressure": rng.random((ni, nj, nk))}
    h5 = str(tmp_path / "s.cgns")
    adf = str(tmp_path / "s_adf.cgns")
    tcgns.write_cgns(mesh, h5, solutions=[sol])
    tadf.hdf5_to_adf(h5, adf)
    got = tcgns.read_cgns_solution(adf)[0]
    for k in sol:
        np.testing.assert_array_equal(got[k], sol[k])


def test_adf_to_hdf5_conversion(tmp_path):
    mesh = tmeshgen.cube_mesh(n=3)
    h5 = str(tmp_path / "a.cgns")
    adf = str(tmp_path / "a_adf.cgns")
    back = str(tmp_path / "a_back.cgns")
    tcgns.write_cgns(mesh, h5)
    tadf.hdf5_to_adf(h5, adf)
    tadf.adf_to_hdf5(adf, back)
    assert_mesh_equal(tcgns.read_cgns(h5), tcgns.read_cgns(back))


def test_adf_big_endian_read(tmp_path):
    vals = np.array([1.5, -2.25, 3.125])
    root = tadf.AdfNode("ADF MotherNode", "Root Node of ADF File", "MT", (),
                        None)
    root.add_child(tadf.AdfNode("V", "DataArray_t", "R8", (), vals))
    p = str(tmp_path / "be.adf")
    tadf.write_adf_tree(root, p)
    buf = bytearray(open(p, "rb").read())
    assert buf[100] == ord("L")
    np.testing.assert_array_equal(
        np.asarray(tadf.read_adf_tree(p)["V"][" data"]), vals)
    buf[100] = ord("B")
    pos = bytes(buf).find(vals.tobytes())
    assert pos > 0
    buf[pos:pos + 24] = vals.byteswap().tobytes()
    pb = str(tmp_path / "be2.adf")
    open(pb, "wb").write(bytes(buf))
    np.testing.assert_array_equal(
        np.asarray(tadf.read_adf_tree(pb)["V"][" data"]), vals)


# -- mesh files across the packages ------------------------------------------

@pytest.mark.parametrize("flavor", ["hdf5", "adf"])
def test_cgns_mesh_files_cross_read(tmp_path, flavor):
    """A mesh written by either package reads equal in the other; the
    port writes the ADF flavour itself, the JAX package through
    ``hdf5_to_adf``."""
    jm, tm = _two_block_mesh(tmp_path)
    pj, pt = str(tmp_path / "j.cgns"), str(tmp_path / "t.cgns")
    jcgns.write_cgns(jm, pj)
    if flavor == "adf":
        from adflow_tpu.io.adf import hdf5_to_adf
        hdf5_to_adf(pj, pj + ".adf")
        pj += ".adf"
    tcgns.write_cgns(tm, pt, flavor=flavor)
    assert tadf.is_adf(pt) == (flavor == "adf")
    for path in (pj, pt):
        assert_mesh_equal(jcgns.read_cgns(path), tcgns.read_cgns(path))
    # the port's file keeps the BC types and family names (the JAX
    # package's writer garbles its string nodes: ROADMAP.md section 3)
    assert_mesh_equal(tm, tcgns.read_cgns(pt))
    assert_mesh_equal(jm, jcgns.read_cgns(pt))
    assert [s.family for s in jcgns.read_cgns(pj).blocks[0].bcs] != [
        s.family for s in jm.blocks[0].bcs]


@pytest.mark.parametrize("fmt", ["cgns", "adf.cgns", "npz", "p3d"])
def test_grid_file(tmp_path, fmt):
    """``gridFile`` builds the same solver as the mesh object: the same
    coordinates, BCs and residual."""
    mesh = tmeshgen.wing_omesh(ni=16, nj=8, nk=8)
    path = str(tmp_path / f"wing.{fmt}")
    if fmt == "npz":
        tmeshio.write_npz(mesh, path)
    elif fmt == "p3d":
        tmeshio.write_plot3d(mesh, path)
    else:
        tcgns.write_cgns(mesh, path,
                         flavor="adf" if fmt.startswith("adf") else "hdf5")
    opts = dict(RK, gridFile=path)
    if fmt == "p3d":
        # plot3d holds coordinates only (exactly, at 17 digits): both
        # packages read them, and both refuse a mesh without BCs
        got = tmeshio.read_mesh(path).blocks[0].x
        assert np.array_equal(got, mesh.blocks[0].x)
        assert np.array_equal(jmeshio.read_mesh(path).blocks[0].x, got)
        with pytest.raises(ValueError) as jerr:
            JaxADFLOW(options=opts)
        with pytest.raises(ValueError) as terr:
            ADFLOW(options=opts, device="cpu")
        assert str(terr.value) == str(jerr.value)
        return
    ap = AeroProblem(name="w", mach=0.84, alpha=3.06)
    from_file = ADFLOW(options=opts, device="cpu")
    assert_mesh_equal(from_file.mesh, mesh)
    from_obj = ADFLOW(options=RK, mesh=mesh, device="cpu")
    r1 = from_file.getResidual(ap)
    r2 = from_obj.getResidual(ap)
    assert torch.equal(r1[0], r2[0])


def test_npz_of_the_jax_package_reads_without_it(tmp_path):
    """A ``.npz`` written by the JAX package pickles its own mesh classes;
    the port reads it into its own, in a process where neither the JAX
    package nor JAX is ever imported."""
    jm = jmeshgen.wing_omesh(ni=8, nj=4, nk=4)
    path = str(tmp_path / "jax_mesh.npz")
    jmeshio.write_npz(jm, path)
    code = (
        "import sys\n"
        "from adflow_torch.io.meshio import read_npz\n"
        f"m = read_npz({path!r})\n"
        "mods = [n for n in sys.modules\n"
        "        if n.split('.')[0] in ('adflow_tpu', 'jax', 'jaxlib')]\n"
        "assert not mods, mods\n"
        "b = m.blocks[0]\n"
        "print(type(b.bcs[0]).__module__, type(b.bcs[0].bc).__module__,\n"
        "      len(b.bcs), len(b.conns))\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    mod, bc_mod, nbc, ncn = out.stdout.split()
    assert mod == bc_mod == "adflow_torch.core.mesh"
    assert (int(nbc), int(ncn)) == (len(jm.blocks[0].bcs),
                                    len(jm.blocks[0].conns))
    assert_mesh_equal(tmeshio.read_npz(path), jm)


# -- solution files and restart ---------------------------------------------

def state_pair(case, **options):
    """Both packages' solvers of a ``torch_pairs`` case at its seeded
    perturbed free stream."""
    from tests import torch_pairs
    js, ts = torch_pairs.solvers(case, **options)
    w0 = torch_pairs.perturbed(np.asarray(js.getStates()), ts.ref.nw)
    js.setStates(w0)
    ts.setStates(w0)
    return js, ts


# the volume menu, split so that the JAX package's op-by-op residual runs
# on the Euler wing only
MENUS = {"rans_plate": ["temp", "eddy", "eddyratio", "dist", "blank"],
         "euler_wing": ["resrho", "resmom", "restot"]}


@pytest.fixture(scope="module")
def pairs():
    """``state_pair`` of each case with its menu, built once a module."""
    cache = {}

    def get(case):
        if case not in cache:
            cache[case] = state_pair(case, volumeVariables=MENUS[case])
        return cache[case]
    return get


@pytest.mark.parametrize("case", sorted(MENUS))
def test_solution_dicts_match(case, pairs):
    """Every variable of the volume menu at the seeded perturbed free
    stream, to 1e-12 of its largest magnitude."""
    js, ts = pairs(case)
    want = js._solution_dicts()
    got = ts._solution_dicts()
    assert len(want) == len(got)
    extra = ({"EddyViscosity", "RatioEddyViscosity", "WallDistance",
              "TurbulentSANuTilde", "Temperature"} if case == "rans_plate"
             else {"ResidualDensity", "ResidualMomentumX", "ResidualTotal"})
    for dj, dt in zip(want, got):
        assert list(dj) == list(dt)
        assert extra <= set(dt)
        for k in dj:
            a = np.asarray(dj[k])
            assert dt[k].dtype == np.float64 and dt[k].shape == a.shape, k
            np.testing.assert_allclose(
                dt[k], a, rtol=0, atol=TOL * max(np.abs(a).max(), 1e-300),
                err_msg=k)


@pytest.mark.parametrize("flavor", ["hdf5", "adf"])
def test_solution_files_cross_read(pairs, tmp_path, flavor):
    """Volume files written by either package read equal in the other."""
    js, ts = pairs("rans_plate")
    pj, pt = str(tmp_path / "j.cgns"), str(tmp_path / "t.cgns")
    js.writeVolumeSolutionFile(pj)
    if flavor == "adf":
        from adflow_tpu.io.adf import hdf5_to_adf
        hdf5_to_adf(pj, pj + ".adf")
        pj += ".adf"
    tcgns.write_cgns(ts.mesh, pt, solutions=ts._solution_dicts(),
                     flavor=flavor)
    for path in (pj, pt):
        sj, st = jcgns.read_cgns_solution(path), tcgns.read_cgns_solution(path)
        for dj, dt in zip(sj, st):
            assert sorted(dj) == sorted(dt)
            for k in dj:
                assert np.array_equal(dj[k], dt[k]), k
    for dj, dt in zip(tcgns.read_cgns_solution(pj),
                      tcgns.read_cgns_solution(pt)):
        assert sorted(dj) == sorted(dt)
        for k in dj:
            np.testing.assert_allclose(
                dt[k], dj[k], rtol=0,
                atol=TOL * max(np.abs(dj[k]).max(), 1e-300), err_msg=k)


@pytest.fixture(scope="module")
def quick_solves():
    """tests/test_io_functions.py's quick solve on both packages: 25 RK
    cycles of the NACA 0012 O-mesh."""
    ap = dict(name="io", mach=0.5, alpha=2.0, evalFuncs=["cl", "cd"])
    js = JaxADFLOW(options=RK, mesh=jmeshgen.naca0012_omesh(ni=48, nj=16))
    jap = JaxAP(**ap)
    js(jap)
    ts = ADFLOW(options=RK, mesh=tmeshgen.naca0012_omesh(ni=48, nj=16),
                device="cpu")
    tap = AeroProblem(**ap)
    ts(tap)
    return js, jap, ts, tap


def test_convergence_history(quick_solves):
    js, _, ts, _ = quick_solves
    hj, ht = js.getConvergenceHistory(), ts.getConvergenceHistory()
    assert sorted(hj) == sorted(ht)
    for k in hj:
        np.testing.assert_allclose(ht[k], np.asarray(hj[k]), rtol=1e-10,
                                   atol=0, err_msg=k)


def test_write_and_restart_roundtrip(quick_solves, tmp_path):
    """writeSolution's numbered files, then restarts: the port from its own
    file and from the JAX package's, the JAX package from the port's; the
    port's restarted state equals the JAX package's to 1e-14."""
    js, jap, ts, tap = quick_solves
    jdir, tdir = tmp_path / "j", tmp_path / "t"
    jdir.mkdir()
    tdir.mkdir()
    js.writeSolution(outputDir=str(jdir), baseName="t")
    ts.writeSolution(outputDir=str(tdir), baseName="t")
    for d in (jdir, tdir):
        assert (d / "t_000_vol.cgns").exists()
        assert (d / "t_000_surf.dat").exists()
    states = {}
    for src in ("j", "t"):
        path = str(tmp_path / src / "t_000_vol.cgns")
        t2 = ADFLOW(options=dict(RK, restartFile=path),
                    mesh=tmeshgen.naca0012_omesh(ni=48, nj=16), device="cpu")
        t2.setAeroProblem(AeroProblem(name="io", mach=0.5, alpha=2.0))
        states[src] = t2.getStates().numpy()
    j2 = JaxADFLOW(options=dict(RK, restartFile=str(tdir / "t_000_vol.cgns")),
                   mesh=jmeshgen.naca0012_omesh(ni=48, nj=16))
    j2.setAeroProblem(JaxAP(name="io", mach=0.5, alpha=2.0))
    want = np.asarray(j2.getStates())
    np.testing.assert_allclose(want, np.asarray(js.getStates()), atol=1e-14)
    for src in ("j", "t"):
        np.testing.assert_allclose(states[src], ts.getStates().numpy(),
                                   atol=1e-14)
        np.testing.assert_allclose(states[src], want, atol=1e-14)


@pytest.mark.parametrize("flavor", ["hdf5", "adf"])
def test_float32_restart_is_bitwise(tmp_path, flavor):
    """A float32 state widened to the file's float64 and read back is
    exact: the restart builds the conservative state in float64 and
    rounds it once."""
    opts = dict(RK, precision="float32", nCycles=3,
                outputDirectory=str(tmp_path))
    s = ADFLOW(options=opts, mesh=tmeshgen.wing_omesh(ni=16, nj=8, nk=8),
               device="cpu")
    ap = AeroProblem(name="w", mach=0.84, alpha=3.06)
    s(ap)
    path = str(tmp_path / "w.cgns")
    tcgns.write_cgns(s.mesh, path, solutions=s._solution_dicts(),
                     flavor=flavor)
    s2 = ADFLOW(options=dict(opts, restartFile=path),
                mesh=tmeshgen.wing_omesh(ni=16, nj=8, nk=8), device="cpu")
    s2.setAeroProblem(ap)
    assert s2.dtype == torch.float32 and not s2._fresh_state
    assert torch.equal(s2.getStates(), s.getStates())
