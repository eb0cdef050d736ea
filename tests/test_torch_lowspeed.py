"""Port parity for the Weiss-Smith low-speed preconditioner (the
``precon_mach`` radii of physics/fluxes.py, ``local_timestep``, and the
``ls_precon_mach`` that ``setAeroProblem`` sets) in float64 on the CPU, on
the 16x8x8 Euler wing at M 0.05 with ``lowSpeedPreconditioner`` at the
seeded perturbed free stream:

- the spectral radii, ``local_timestep`` and the block residual, to 1e-12
  (the radii and time steps relative, the residual of the flux scale);
- beta^2 clipped to 1 reproduces the unpreconditioned radii exactly, as
  tests/test_lowspeed.py:51 holds the JAX package;
- one preconditioned ANK step, its stats and new state to 1e-10.
"""

import numpy as np
import pytest
import torch

from adflow_torch.physics.fluxes import spectral_radii as t_radii
from adflow_torch.physics.thermo import pressure as t_pressure
from adflow_torch.physics.timestep import local_timestep as t_timestep
from adflow_tpu.physics.fluxes import spectral_radii as j_radii
from adflow_tpu.physics.thermo import pressure as j_pressure
from adflow_tpu.physics.timestep import local_timestep as j_timestep
from tests.torch_pairs import (
    SHORT, block_residual_pair, check_ank_step, flux_scale, rel,
    variant_pair)

TOL = 1e-12
LOW = dict(mach=0.05)


@pytest.fixture(scope="module")
def wing():
    return variant_pair("euler_wing", LOW, lowSpeedPreconditioner=True)


def test_precon_mach_set(wing):
    assert wing.ts.cfg.ls_precon_mach == wing.js.cfg.ls_precon_mach == 0.05


def test_radii_and_timestep_match_jax(wing):
    js, ts = wing.js, wing.ts
    wj, wt = wing.wj[0], wing.wt[0]
    mj, mt = js.metrics_list[0], ts.metrics_list[0]
    pm = ts.cfg.ls_precon_mach
    want = j_radii(wj, j_pressure(wj), mj, pm)
    got = t_radii(wt, t_pressure(wt), mt, pm)
    plain = t_radii(wt, t_pressure(wt), mt)
    for a, b, c in zip(want, got, plain):
        assert rel(a, b.numpy()) < TOL
        # the preconditioner lowers the acoustic radii
        assert float((c - b).min()) > 0.0
    dt_j = j_timestep(wj, j_pressure(wj), mj, 7.0, js.cfg, js.ref)
    dt_t = t_timestep(wt, t_pressure(wt), mt, 7.0, ts.cfg, ts.ref)
    assert rel(dt_j, dt_t.numpy()) < TOL


def test_residual_matches_jax(wing):
    want, got = block_residual_pair(wing.js, wing.ts, wing.wj, wing.wt)
    scale = flux_scale(wing.wj[0], wing.js.metrics_list[0])
    assert np.abs(want - got).max() <= TOL * scale
    _, plain = block_residual_pair(wing.js, wing.ts, wing.wj, wing.wt,
                                   {"ls_precon_mach": 0.0})
    assert np.abs(plain - got).max() > 1e-6 * scale


def test_unit_beta_recovers_plain_radii(wing):
    wt, mt = wing.wt[0], wing.ts.metrics_list[0]
    p = t_pressure(wt)
    for a, b in zip(t_radii(wt, p, mt), t_radii(wt, p, mt, precon_mach=2.0)):
        assert float(torch.max(torch.abs(a - b))) < 1e-10 * float(a.max())


def test_ank_step_matches_jax(wing):
    check_ank_step(wing, "coupled", SHORT)
