"""Port parity: metrics and wall distance (adflow_torch.geom vs
adflow_tpu.geom) in float64 on the CPU, to 1e-13 relative.

Cases: a randomly perturbed cube (walls on every face, so every cell has a
wall distance) and the wing O-mesh, whose i-wrap is a b2b self-connection
(true ghost metrics from exchanged halo nodes).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adflow_tpu.geom.metrics import compute_metrics_conn as jax_metrics
from adflow_tpu.geom.walldist import compute_wall_distances as jax_walldist
from adflow_tpu.meshgen.analytic import cube_mesh, wing_omesh
from adflow_torch.core.mesh import BCType
from adflow_torch.geom.metrics import compute_metrics_conn, pad_like_numpy
from adflow_torch.geom.walldist import compute_wall_distances
from adflow_torch.meshgen import analytic as torch_analytic

RTOL = 1e-13

CASES = {
    "cube": lambda m: m.cube_mesh(n=6, perturb=0.2, seed=5,
                                  bc=m.BCType.NS_WALL_ADIABATIC),
    "wing": lambda m: m.wing_omesh(ni=24, nj=12, nk=8, viscous=True),
}


def _close(a, b, rtol=RTOL):
    a = np.asarray(a)
    b = b.detach().cpu().numpy() if isinstance(b, torch.Tensor) else b
    assert a.shape == b.shape
    scale = np.abs(a).max() + 1e-300
    err = np.abs(a - b).max() / scale
    assert err < rtol, err


def _both(case):
    from adflow_tpu.meshgen import analytic as jax_analytic
    mj = CASES[case](jax_analytic)
    mt = CASES[case](torch_analytic)
    xj = [jnp.asarray(b.x, jnp.float64) for b in mj.blocks]
    xt = [torch.as_tensor(b.x, dtype=torch.float64) for b in mt.blocks]
    return mj, mt, xj, xt


@pytest.mark.parametrize("case", sorted(CASES))
def test_metrics_match(case):
    mj, mt, xj, xt = _both(case)
    for a, b in zip(jax_metrics(mj.blocks, xj), compute_metrics_conn(mt.blocks, xt)):
        for field in ("siE", "sjE", "skE", "vol", "xc_ext"):
            _close(getattr(a, field), getattr(b, field))


@pytest.mark.parametrize("case", sorted(CASES))
def test_wall_distance_matches(case):
    mj, mt, xj, xt = _both(case)
    dj = jax_walldist(mj, xj, jnp.float64)
    dt = compute_wall_distances(mt, xt)
    for a, b in zip(dj, dt):
        _close(a, b)


@pytest.mark.parametrize("mode,width", [("edge", 1), ("symmetric", 2)])
def test_pad_like_numpy(mode, width):
    a = np.random.default_rng(0).normal(size=(3, 1, 4, 2))
    got = pad_like_numpy(torch.as_tensor(a), width, mode).numpy()
    want = np.pad(a, [(width, width)] * 3 + [(0, 0)], mode=mode)
    np.testing.assert_array_equal(got, want)


def test_cube_walls_everywhere_is_a_wall_mesh():
    mesh = CASES["cube"](torch_analytic)
    assert all(sf.bc is BCType.NS_WALL_ADIABATIC for sf in mesh.blocks[0].bcs)
