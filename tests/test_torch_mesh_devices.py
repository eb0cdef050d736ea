"""``ADFLOW(meshDevices=N)`` on N gloo ranks (one process each, spawned
by tests/torch_dist.py) through ``__call__`` and ``evalFunctions``, in
float64 on the CPU:

- on 4 ranks the NACA 0012 of tests/test_mesh_devices.py converges to
  1e-6 of its first residual, and its cl is within 2e-4 of the
  single-device solve of the port (against the JAX package's four-device
  solve it is slow: the JAX side compiles the stacked steps);
- on 8 ranks the cube's states come back finite;
- ``haloExchangeMode: 'ppermute'`` raises naming 'gather', and a group
  whose size is not ``meshDevices`` raises ``ValueError``, as does
  ``meshDevices > 1`` with no process group.
"""

import numpy as np
import pytest

import torch_dist as td
from adflow_torch.api.solver import ADFLOW
from adflow_torch.core.refstate import AeroProblem
from adflow_torch.meshgen.analytic import cube_mesh, naca0012_omesh

CL_RTOL = 2e-4
NACA = ("naca0012_omesh", dict(ni=48, nj=16))
NACA_AP = dict(name="md", mach=0.5, alpha=2.0, evalFuncs=["cl"])


def _single_device_cl():
    s = ADFLOW(options=td.API_BASE, mesh=naca0012_omesh(**NACA[1]),
               device="cpu")
    ap = AeroProblem(**NACA_AP)
    s(ap)
    funcs = {}
    s.evalFunctions(ap, funcs)
    assert s.solve_info.converged
    return funcs["md_cl"]


def test_mesh_devices_matches_single_device(tmp_path):
    """meshDevices=4 converges to the single-device cl (partition
    invariance through the API); the one-device solve runs here while the
    ranks work."""
    world = td.World(4, "api_results", tmp_path, *NACA, NACA_AP, {})
    cl1 = _single_device_cl()
    got = world.result()
    assert got["n_blocks"] >= 4 and got["finite"]
    assert got["converged"], got
    np.testing.assert_allclose(got["funcs"]["md_cl"], cl1, rtol=CL_RTOL)


def test_mesh_devices_state_finite(tmp_path):
    """One RK start and 5 ANK steps (the JAX package's test runs 30 cycles;
    from the cube's free stream every step is a GMRES solve of a round-off
    residual to its full 100 iterations, 3 s a step here)."""
    got = td.run_world(8, "api_results", tmp_path, "cube_mesh", dict(n=8),
                       dict(name="s8", mach=0.4, alpha=1.0),
                       dict(nCycles=6, L2Convergence=1e-1))
    assert got["finite"] and got["n_blocks"] >= 8


def test_refusals(tmp_path):
    got = td.run_world(2, "api_refusals", tmp_path)
    assert got["ppermute"][0] == "NotImplementedError"
    assert "gather" in got["ppermute"][1]
    assert got["size"] == ("ValueError", "meshDevices=4 but the process "
                           "group has 2 ranks")
    with pytest.raises(ValueError, match="meshDevices=2 runs one process"):
        ADFLOW(options={"meshDevices": 2}, mesh=cube_mesh(n=6),
               device="cpu")


@pytest.mark.slow
def test_mesh_devices_matches_jax(tmp_path):
    """The port's four ranks against the JAX package's four virtual
    devices: cl to 2e-4, as each is held to its single-device solve."""
    from adflow_tpu.api.solver import ADFLOW as JaxADFLOW
    from adflow_tpu.core.refstate import AeroProblem as JaxAP
    from adflow_tpu.meshgen.analytic import naca0012_omesh as jax_naca

    world = td.World(4, "api_results", tmp_path, *NACA, NACA_AP, {})
    js = JaxADFLOW(options=dict(td.API_BASE, meshDevices=4),
                   mesh=jax_naca(**NACA[1]))
    ap = JaxAP(**NACA_AP)
    js(ap)
    funcs = {}
    js.evalFunctions(ap, funcs)
    got = world.result()
    assert js.solve_info.converged and got["converged"]
    np.testing.assert_allclose(got["funcs"]["md_cl"], funcs["md_cl"],
                               rtol=CL_RTOL)
