"""Port parity: options, mesh generators and reference state.

The numpy-only modules of adflow_tpu are copied into adflow_torch (an
import of any adflow_tpu module runs adflow_tpu/__init__.py, which imports
jax). These tests hold the copies to the originals: identical option
defaults and errors (with ``useBlockettes`` the one recorded difference),
identical node arrays and boundary data, equal free-stream states.
"""

import dataclasses

import numpy as np
import pytest

from adflow_tpu import options as jax_options
from adflow_tpu.core import refstate as jax_refstate
from adflow_tpu.meshgen import analytic as jax_analytic
from adflow_torch import options as torch_options
from adflow_torch.core import refstate as torch_refstate
from adflow_torch.meshgen import analytic as torch_analytic


def test_option_defaults_match_except_use_blockettes():
    jd = jax_options.get_default_options()
    td = torch_options.get_default_options()
    assert set(jd) == set(td)
    diff = sorted(k for k in jd if jd[k] != td[k])
    # deliberate difference: the JAX package keeps its fused kernel off
    # because of a TPU-only Mosaic DMA fault (adflow_tpu/options.py:66-73);
    # the port's kernel is the residual on CUDA
    assert diff == ["useBlockettes"]
    assert jd["useBlockettes"] is False and td["useBlockettes"] is True


@pytest.mark.parametrize("opts", [
    {"CFLLimt": 2.0},                              # typo -> did-you-mean
    {"notAnOption": 1},
    {"equationType": "navier"},                    # invalid enum value
    {"smoother": "jacobi"},
    {"liftIndex": 4},
    {"gammaConstant": 1.3},
])
def test_option_errors_match(opts):
    with pytest.raises(Exception) as ej:
        jax_options.Options(opts)
    with pytest.raises(Exception) as et:
        torch_options.Options(opts)
    assert type(ej.value) is type(et.value)
    assert str(ej.value) == str(et.value)


def test_option_access_matches():
    user = {"cfl": 2.5, "EQUATIONTYPE": "euler", "nCycles": 7}
    jo, to = jax_options.Options(user), torch_options.Options(user)
    for k in ("CFL", "equationType", "ncycles", "vis4"):
        assert jo[k] == to[k]
    assert jo.replace(CFL=3.0)["cfl"] == to.replace(CFL=3.0)["cfl"]


def _bc_data(mesh):
    out = []
    for b in mesh.blocks:
        out.append((b.name, [(sf.face.name, sf.bc.value, sf.family, sf.rng)
                             for sf in b.bcs],
                    [(c.face.name, c.donor_block, c.donor_face.name,
                      c.transform, c.offset) for c in b.conns]))
    return out


@pytest.mark.parametrize("gen,kwargs", [
    ("cube_mesh", dict(n=5, perturb=0.2, seed=3)),
    ("wing_omesh", dict(ni=24, nj=12, nk=8, viscous=True)),
    ("flatplate_mesh", dict(ni=16, nj=8)),
])
def test_mesh_generators_identical(gen, kwargs):
    mj = getattr(jax_analytic, gen)(**kwargs)
    mt = getattr(torch_analytic, gen)(**kwargs)
    assert len(mj.blocks) == len(mt.blocks)
    for bj, bt in zip(mj.blocks, mt.blocks):
        np.testing.assert_array_equal(bj.x, bt.x)
    assert _bc_data(mj) == _bc_data(mt)


@pytest.mark.parametrize("ap_kwargs,lift_index", [
    (dict(name="m6", mach=0.84, alpha=3.06, reynolds=11.72e6), 2),
    (dict(name="w", mach=0.8, alpha=1.5, beta=2.0, reynolds=1e6,
          areaRef=2.7, chordRef=0.9), 3),
    (dict(name="e", mach=0.5, alpha=2.0), 2),
])
def test_reference_state_equal(ap_kwargs, lift_index):
    rj = jax_refstate.make_reference_state(
        jax_refstate.AeroProblem(**ap_kwargs), lift_index=lift_index,
        n_turb=1)
    rt = torch_refstate.make_reference_state(
        torch_refstate.AeroProblem(**ap_kwargs), lift_index=lift_index,
        n_turb=1)
    np.testing.assert_array_equal(rj.winf(), rt.winf())
    assert rj.mu_inf == rt.mu_inf
    dj, dt = dataclasses.asdict(rj), dataclasses.asdict(rt)
    for k in dj:
        np.testing.assert_array_equal(dj[k], dt[k])
