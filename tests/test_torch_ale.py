"""Port parity for rigid grid motion (ALE: geom/metrics.py
``add_grid_motion``, the grid-velocity terms of physics/fluxes.py, bc.py,
sa.py and sst.py, and the adjoint's design variables rotRate, rotCenter
and machGrid) in float64 on the CPU:

- the face velocities ``setAeroProblem`` attaches for an aero problem with
  rotRate, rotCenter and machGrid, to 1e-14;
- free-stream preservation (the ALE GCL) under translation on the
  perturbed cube and under rotation on the uniform cube, below 1e-12, as
  tests/test_ale.py:43-55 hold the JAX package;
- the block residual with grid motion on the 16x8x8 Euler wing and on the
  16x12 RANS plate (its moving no-slip wall and the SA advection in the
  grid's frame), to 1e-12 of the flux scale; and SST's advection in the
  grid's frame on the plate;
- the adjoint's residual vjp in w, x and every design variable, rotRate,
  rotCenter and machGrid among them, to 1e-10;
- ``evalFunctionsSens`` returns the grid-motion totals, rotRate per rad/s.
"""

import numpy as np
import pytest
import torch

from adflow_torch.api.solver import ADFLOW
from adflow_torch.core.mesh import BCType
from adflow_torch.core.refstate import AeroProblem, make_reference_state
from adflow_torch.geom.metrics import add_grid_motion, compute_metrics
from adflow_torch.meshgen.analytic import cube_mesh
from adflow_torch.physics.residual import (
    ProblemConfig, build_topology, residual_list)
from tests.torch_pairs import (
    QUIET, adjoint_pair, block_residual_pair, check_residual_vjp,
    flux_scale, rel, variant_pair)

MOTION = dict(rotRate=(0.0, 0.0, 30.0), rotCenter=(0.25, 0.1, 0.0),
              machGrid=0.1)
RES_TOL = 1e-12
VJP_TOL = 1e-10


@pytest.fixture(scope="module")
def wing():
    return variant_pair("euler_wing", MOTION)


def test_face_velocities_match_jax(wing):
    mj, mt = wing.js.metrics_list[0], wing.ts.metrics_list[0]
    for a, b in ((mj.vfIE, mt.vfIE), (mj.vfJE, mt.vfJE),
                 (mj.vfKE, mt.vfKE)):
        assert b is not None and b.shape == np.shape(a)
        assert rel(a, b.numpy()) < 1e-14


def _fs_residual(mesh, omega, center, vtrans):
    topo = build_topology(mesh)
    cfg = ProblemConfig(equation_type="euler", vis2=0.25, vis4=1 / 64,
                        diss_exponent=0.67)
    ref = make_reference_state(AeroProblem(name="fs", mach=0.6, alpha=5.0,
                                           beta=2.0), n_turb=0)
    winf = torch.as_tensor(ref.winf())
    x_list = [torch.as_tensor(b.x) for b in mesh.blocks]
    metrics = [add_grid_motion(compute_metrics(x), x, omega, center, vtrans)
               for x in x_list]
    w_list = [winf.expand(tuple(d + 4 for d in b.dims) + (5,)).clone()
              for b in mesh.blocks]
    r = residual_list(w_list, metrics, topo, cfg, ref, winf)
    return max(float(torch.max(torch.abs(rb))) for rb in r)


@pytest.mark.parametrize("motion", ["translation", "rotation"])
def test_free_stream_preserved(motion):
    if motion == "translation":
        # any mesh: sum of S_f = 0 per cell
        err = _fs_residual(cube_mesh(n=6, perturb=0.25), (0, 0, 0),
                           (0, 0, 0), (0.3, -0.2, 0.1))
    else:
        # the velocity divergence telescopes with centroid velocities
        err = _fs_residual(cube_mesh(n=6), (0.2, -0.4, 0.7),
                           (0.3, 0.4, 0.5), (0.1, 0.0, -0.2))
    assert err < 1e-12


@pytest.mark.parametrize("case,options", [
    ("euler_wing", {}), ("rans_plate", {}),
    ("rans_plate", {"turbulenceModel": "SST"})])
def test_residual_matches_jax(wing, case, options):
    pair = (wing if case == "euler_wing"
            else variant_pair(case, dict(machGrid=0.2), **options))
    m = pair.ts.metrics_list[0]
    assert m.vfIE is not None
    want, got = block_residual_pair(pair.js, pair.ts, pair.wj, pair.wt)
    scale = flux_scale(pair.wj[0], pair.js.metrics_list[0])
    assert np.abs(want - got).max() <= RES_TOL * scale
    # the grid's motion is in the residual
    static = pair.ts.metrics_list[0]._replace(vfIE=None, vfJE=None,
                                             vfKE=None)
    from adflow_torch.physics.residual import block_residual
    r0 = block_residual(pair.wt[0], static, pair.ts.cfg, pair.ts.ref,
                        pair.ts.extras_list[0] if pair.ts.extras_list
                        else None, por=pair.ts.topo.blocks[0].por).numpy()
    assert np.abs(r0 - got).max() > 1e-6 * scale


def test_adjoint_residual_vjp_matches_jax():
    js, ts = adjoint_pair("euler_wing", MOTION)
    want = check_residual_vjp(js, ts, jit=True)
    assert {"rotRate", "rotCenter", "machGrid"} <= set(want[2])
    assert all(float(np.abs(want[2][k]).max()) > 0.0
               for k in ("rotRate", "rotCenter", "machGrid"))


def test_eval_functions_sens_grid_variables():
    solver = ADFLOW(options=dict(QUIET, equationType="euler",
                                 adjointMaxIter=10, adjointSubspaceSize=10),
                    mesh=cube_mesh(n=4, bc=BCType.FARFIELD), device="cpu")
    ap = AeroProblem(name="c", mach=0.5, alpha=1.0, evalFuncs=["cl"],
                     **MOTION)
    sens = solver.evalFunctionsSens(ap, {})["c_cl"]
    params = solver._ap_params(ap)
    assert float(params["rotRate"][2]) == 30.0 / ap.a_dim
    assert np.shape(sens["rotRate"]) == np.shape(sens["rotCenter"]) == (3,)
    assert all(np.all(np.isfinite(sens[k]))
               for k in ("rotRate", "rotCenter", "machGrid"))
