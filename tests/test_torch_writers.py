"""The port's post-processing writers against the JAX package, float64 on
the CPU, at the seeded perturbed free stream: the slice, lift, Tecplot
volume, isosurface and surface-solution files of both packages, parsed
back (the surface-sensitivity file is in test_torch_outer_solves.py, with
the adjoint it shares). The numbers agree to 1e-10 relative, the headers
and zone sizes are equal (the TITLE line names the package), after
tests/test_api_extras.py::test_slices_and_force_file and the writer cases
of tests/test_io_functions.py.
"""

import numpy as np
import pytest

from tests import torch_pairs

RTOL = 1e-10


def parse(path):
    """(header lines without the TITLE, numeric rows) of a Tecplot file."""
    heads, rows = [], []
    for line in open(path):
        toks = line.split()
        try:
            rows.append([float(t) for t in toks])
        except ValueError:
            if not line.startswith("TITLE"):
                heads.append(line.rstrip("\n"))
    return heads, rows


def assert_files_agree(pj, pt):
    hj, rj = parse(pj)
    ht, rt = parse(pt)
    assert hj == ht
    assert [len(r) for r in rj] == [len(r) for r in rt]
    a = np.concatenate([np.asarray(r) for r in rj]) if rj else np.zeros(0)
    b = np.concatenate([np.asarray(r) for r in rt]) if rt else np.zeros(0)
    scale = max(np.abs(a).max(initial=0.0), 1e-300)
    np.testing.assert_allclose(b, a, rtol=RTOL, atol=1e-13 * scale)
    return hj, a


def both(pair, tmp_path, name, write):
    pj, pt = str(tmp_path / f"j_{name}"), str(tmp_path / f"t_{name}")
    write(pair[0], pj)
    write(pair[1], pt)
    return assert_files_agree(pj, pt)


def state_pair(case, **options):
    js, ts = torch_pairs.solvers(case, **options)
    w0 = torch_pairs.perturbed(np.asarray(js.getStates()), ts.ref.nw)
    js.setStates(w0)
    ts.setStates(w0)
    return js, ts


@pytest.fixture(scope="module")
def wing():
    return state_pair("euler_wing", volumeVariables=["resrho", "temp"],
                      surfaceVariables=["cp", "vx", "vy", "vz", "mach", "rho",
                                        "p", "temp"])


@pytest.fixture(scope="module")
def plate():
    return state_pair("rans_plate", surfaceVariables=[
        "cp", "vx", "vy", "vz", "cf", "yplus", "mach", "rho", "p", "temp"])


def test_slices(wing, tmp_path):
    def write(s, path):
        s.addSlices("z", [0.5, 1.5])
        s.addSlices("x", 0.3)
        s.writeSlicesFile(path)
    heads, vals = both(wing, tmp_path, "slices.dat", write)
    assert any("FELINESEG" in h for h in heads) and len(vals)
    assert sum('T="slice_' in h for h in heads) == 2


def test_lift_distribution(wing, tmp_path):
    def write(s, path):
        s.addLiftDistribution(8, "z")
        s.addLiftDistribution(4, "y")
        s.writeLiftDistributionFile(path)
    heads, vals = both(wing, tmp_path, "lift.dat", write)
    assert sum("ZONE" in h for h in heads) == 2


def test_tecplot_volume(wing, tmp_path):
    heads, vals = both(wing, tmp_path, "vol.dat",
                       lambda s, p: s.writeTecplotVolumeFile(p))
    assert "ResidualDensity" in heads[0] and "Temperature" in heads[0]
    assert heads[1].startswith("ZONE") and "I=17 J=9 K=9" in heads[1]
    assert np.isfinite(vals).all()


def test_isosurface(wing, tmp_path):
    def write(s, path):
        s.writeIsoSurfaceFile(path, {"mach": 0.8403, "Density": 1.0005})
    heads, vals = both(wing, tmp_path, "iso.dat", write)
    zones = [h for h in heads if "FETRIANGLE" in h]
    assert len(zones) == 2
    assert all("N=0" not in z for z in zones)


@pytest.mark.parametrize("case", ["wing", "plate"])
def test_surface_solution(case, request, tmp_path):
    heads, vals = both(request.getfixturevalue(case), tmp_path, "surf.dat",
                       lambda s, p: s.writeSurfaceSolutionFile(p))
    if case == "plate":
        assert '"Cf"' in heads[0] and '"YPlus"' in heads[0]
    assert np.isfinite(vals).all()
