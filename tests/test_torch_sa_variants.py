"""Port parity for the SA variants and second-order turbulence advection
(physics/sa.py, physics/viscous.py) in float64 on the CPU, on the 16x8x8
viscous wing with RANS at the seeded perturbed free stream of
tests/torch_pairs.py:

- the block residual with rotation-SA, SA-Edwards, QCR and second-order
  SA advection, each alone, and all four together, to 1e-12 of the flux
  scale, the SA row to 1e-11 of its own largest entry (second-order SST
  advection is in tests/test_torch_sst.py);
- the jvp and vjp of the block residual, to 1e-10: all four together in
  the fast tier, each alone slow;
- the kernels' routing on a stand-in CUDA f32 tensor: K1 takes first-order
  SA advection only (second order stays on the plain path, a condition
  the JAX package's routing lacks), and declines rotation-SA, QCR,
  SA-Edwards and SST, whose mean flow K2 takes; neither kernel takes grid
  motion or the low-speed preconditioner.
"""

import types

import numpy as np
import pytest
import torch

from adflow_torch.geom.metrics import BlockMetrics
from adflow_torch.physics import residual as tres
from tests.torch_pairs import (
    block_residual_pair, check_block_derivatives, flux_scale, variant_pair)

RES_TOL = 1e-12
DERIV_TOL = 1e-10
VARIANTS = {
    "rotation": {"use_rotation_sa": True},
    "edwards": {"turbulence_model": "sa-edwards"},
    "qcr": {"use_qcr": True},
    "second order": {"turb_order": "second order"},
}
VARIANTS["all four"] = {k: v for d in VARIANTS.values() for k, v in d.items()}


@pytest.fixture(scope="module")
def wing():
    return variant_pair("rans_wing")


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_residual_matches_jax(wing, variant):
    want, got = block_residual_pair(wing.js, wing.ts, wing.wj, wing.wt,
                                    VARIANTS[variant])
    base, _ = block_residual_pair(wing.js, wing.ts, wing.wj, wing.wt) \
        if variant == "all four" else (None, None)
    scale = flux_scale(wing.wj[0], wing.js.metrics_list[0])
    assert want.shape == got.shape == (16, 8, 8, 6)
    assert np.abs(want - got).max() <= RES_TOL * scale
    # the SA row, whose largest entry is some 1e-4 of the flux scale, to
    # 1e-11 of its own
    sa = np.abs(want[..., 5]).max()
    assert np.abs(want[..., 5] - got[..., 5]).max() <= 10 * RES_TOL * sa
    if base is not None:
        # the variants change the residual
        assert np.abs(want - base).max() > 1e-9 * scale


@pytest.mark.parametrize("variant", [
    pytest.param(v, marks=() if v == "all four" else pytest.mark.slow)
    for v in sorted(VARIANTS)])
def test_jvp_and_vjp_match_jax(wing, variant):
    """Each alone is slow (about 10 s a case on one CPU worker, most of it
    the JAX package's compile)."""
    check_block_derivatives(wing, VARIANTS[variant], tol=DERIV_TOL)


CFG = dict(equation_type="rans", vis2=0.25, vis4=1.0 / 64,
           diss_exponent=0.67, use_kernels=True)


@pytest.mark.parametrize("changes,k1,k2", [
    ({}, True, True),
    ({"turb_order": "first order"}, True, True),
    ({"turb_order": "second order"}, False, True),
    ({"turb_order": "Second Order"}, False, True),
    ({"use_rotation_sa": True}, False, True),
    ({"use_qcr": True}, False, True),
    ({"turbulence_model": "sa-edwards"}, False, True),
    ({"turbulence_model": "sst"}, False, True),
    ({"ls_precon_mach": 0.05}, False, False),
    ({"grid_motion": True}, False, False),
])
def test_kernel_routing(changes, k1, k2):
    """K1's and K2's conditions on a stand-in CUDA f32 block (no array is
    allocated); an actuator source sends a K1 block to K2 as well."""
    changes = dict(changes)
    moving = changes.pop("grid_motion", False)
    cfg = tres.ProblemConfig(**CFG, **changes)
    w = types.SimpleNamespace(dtype=torch.float32, is_cuda=True,
                              shape=(20, 12, 12, 6))
    m = BlockMetrics(*(None,) * 5, vfIE=object() if moving else None)
    extras = {"walldist": None}
    assert tres._kernel_applies(w, m, cfg, extras, (None,) * 3) is k1
    assert tres._inviscid_kernel_applies(w, m, cfg, (None,) * 3) is k2
    if k1:
        assert not tres._kernel_applies(
            w, m, cfg, dict(extras, act_src_momentum=None), (None,) * 3)
