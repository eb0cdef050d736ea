"""Port parity for the actuator regions (``ADFLOW.addActuatorRegion`` and
the ``act_src_momentum`` term of ``block_residual``) in float64 on the
CPU, on the 16x8x2 Euler channel (subsonic inflow and outflow, slip walls)
at the seeded perturbed free stream, with a disk of thrust and torque
across the channel:

- the source arrays ``addActuatorRegion`` builds, to 1e-14;
- the block residual with the sources (the energy row f . u evaluated at
  the current state), to 1e-12 of the flux scale;
- the discrete momentum balance on the port alone, the check of
  tests/test_actuator_mphys.py:23 at the residual level: the sources sum
  to the thrust along the axis and their moments to the torque, and the
  residual falls by exactly their sum (momentum) and by the sum of f . u
  (energy); three RK cycles accelerate the flow through the disk.
"""

import numpy as np
import pytest
import torch

from tests.torch_pairs import block_residual_pair, flux_scale, rel, \
    variant_pair

AXIS = ([1.4, 0.5, 0.1], [1.6, 0.5, 0.1])
THRUST, TORQUE = 0.01, 0.002


@pytest.fixture(scope="module")
def channel():
    pair = variant_pair("channel")
    for s in (pair.js, pair.ts):
        s.addActuatorRegion(*AXIS, radius=10.0, thrust=THRUST, torque=TORQUE)
    return pair


def test_sources_match_jax(channel):
    want = np.asarray(channel.js.extras_list[0]["act_src_momentum"])
    got = channel.ts.extras_list[0]["act_src_momentum"].numpy()
    assert got.shape == (16, 8, 2, 5)
    assert np.count_nonzero(np.abs(got).sum(axis=-1)) > 0
    assert rel(want, got) < 1e-14


def test_residual_matches_jax(channel):
    want, got = block_residual_pair(channel.js, channel.ts, channel.wj,
                                    channel.wt)
    scale = flux_scale(channel.wj[0], channel.js.metrics_list[0])
    assert np.abs(want - got).max() <= 1e-12 * scale


def test_momentum_balance(channel):
    from adflow_torch.geom.metrics import cell_centers
    from adflow_torch.physics.residual import block_residual

    ts = channel.ts
    src = ts.extras_list[0]["act_src_momentum"]
    f = src[..., 1:4].sum(dim=(0, 1, 2))
    axhat = np.subtract(AXIS[1], AXIS[0]) / 0.2
    assert np.allclose(f.numpy(), THRUST * axhat, rtol=0, atol=1e-15)
    rel_pos = cell_centers(ts.x_list[0]) - torch.tensor(AXIS[0])
    moment = torch.linalg.cross(rel_pos, src[..., 1:4], dim=-1).sum(
        dim=(0, 1, 2))
    assert abs(float(moment @ torch.tensor(axhat)) - TORQUE) < 1e-15

    wt, m, por = channel.wt[0], ts.metrics_list[0], ts.topo.blocks[0].por
    r = block_residual(wt, m, ts.cfg, ts.ref, ts.extras_list[0], por=por)
    r0 = block_residual(wt, m, ts.cfg, ts.ref, None, por=por)
    d = (r - r0).sum(dim=(0, 1, 2))
    u = wt[2:-2, 2:-2, 2:-2, 1:4] / wt[2:-2, 2:-2, 2:-2, 0:1]
    work = float((src[..., 1:4] * u).sum())
    assert abs(float(d[0])) < 1e-15
    assert np.allclose(d[1:4].numpy(), -f.numpy(), rtol=0, atol=1e-14)
    assert abs(float(d[4]) + work) < 1e-14


def test_rk_cycles_accelerate_the_disk(channel):
    """Three RK cycles from the same state with and without the disk: the
    disk adds x momentum where it acts."""
    from adflow_torch.solvers.smoothers import rk_iteration

    ts = channel.ts
    mask = ts.extras_list[0]["act_src_momentum"][..., 1] > 0

    def run(extras):
        w = ts.w_list
        for _ in range(3):
            w, _ = rk_iteration(w, ts.metrics_list, ts.topo, ts.cfg, ts.ref,
                                ts.winf, 1.0, extras)
        return w[0][2:-2, 2:-2, 2:-2]

    w_act, w_off = run(ts.extras_list), run(None)
    assert bool(torch.isfinite(w_act).all())
    gain = (w_act[..., 1] - w_off[..., 1])[mask]
    assert float(gain.min()) > 0.0
