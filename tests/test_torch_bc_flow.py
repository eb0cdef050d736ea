"""Port parity for the inflow, outflow and domain-interface BCs
(physics/bc.py) and the flow-through functions (physics/surface.py
``flow_through``), in float64 on the CPU.

On the channel of meshgen/analytic.py at 16x8x2 (its imin and imax faces
given each BC type in turn, with seeded per-subface data arrays where the
type takes them), at a seeded perturbed free stream:
- ``fill_halos`` of the port against the JAX package's, to 1e-13 of the
  largest state entry, for each newly ported BC type;
- the residual's jvp and vjp (``res_flat``, halo fill included) on two
  channels whose imin faces carry four and five inflow types (the second
  slow) and whose imax faces carry the four outflow types, to 1e-10;
- slow: the adjoint's residual vjp in w, x and the design variables on
  the channel (total-conditions inflow) to 1e-10; where the JAX package takes
  ``float()`` of the free stream (the prescribed-state inflow) and so raises
  under a derivative in the design variables, the port's jvp in mach
  against a central difference of the JAX residual, to 1e-8;
- ``evalFunctions`` with the flow-through functions on the channel and
  (slow) on the 16x12 RANS plate (its subsonic outflow), to 1e-12.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import adflow_torch.core.mesh as tmesh
import adflow_torch.meshgen.analytic as tgen
import adflow_tpu.core.mesh as jmesh
import adflow_tpu.meshgen.analytic as jgen
from adflow_torch.api.solver import ADFLOW
from adflow_torch.core.refstate import GAMMA, AeroProblem
from adflow_torch.interop import params_from_numpy
from adflow_torch.solvers import newton
from adflow_tpu.api.solver import ADFLOW as JaxADFLOW
from adflow_tpu.core.refstate import AeroProblem as JaxAP
from adflow_tpu.solvers import newton as jax_newton
from tests.torch_pairs import (
    QUIET, check_residual_vjp, jax_params, perturbed, rel, solvers)

FILL_TOL = 1e-13
DERIV_TOL = 1e-10
FUNC_TOL = 1e-12
# a central difference of step 1e-6 in f64: its rounding, about 1e-16 of
# the residual over the step, is some 1e-10 of the largest entry
FD_TOL = 1e-8
DIMS = (16, 8, 2)
MACH = 0.4
CHANNEL_AP = dict(name="ch", mach=MACH, alpha=0.0,
                  evalFuncs=["mdot", "mavgptot", "mavgttot", "mavgps",
                             "mavgmn", "aavgptot", "aavgps", "area"])
P_INF = 1.0 / GAMMA
PT_INF = P_INF * (1 + 0.2 * MACH ** 2) ** 3.5
TT_INF = 1 + 0.2 * MACH ** 2
# the free stream's velocity, as the prescribed-state BCs default to it
U_INF = MACH * np.sqrt(GAMMA * P_INF)


def _data(kind, shape, seed):
    """Seeded BC data over a subface of (T1, T2) cells."""
    rng = np.random.default_rng(seed)

    def arr(v, amp=0.01):
        return v * (1.0 + amp * rng.standard_normal(shape))

    return {
        "subsonic inflow": {"Pt": arr(PT_INF), "Tt": arr(TT_INF)},
        "subsonic inflow, mass flow": {
            "rho": 1.02, "vmag": arr(0.9 * U_INF),
            "dir": np.array([1.0, 0.05, 0.0])},
        "mass bleed inflow": {},
        "domain interface total": {"Pt": arr(PT_INF), "Tt": TT_INF,
                                   "dir": np.array([1.0, -0.05, 0.01])},
        "domain interface rhouvw": {"rho": arr(1.0), "vx": arr(U_INF),
                                    "vy": 0.01 * U_INF},
        "supersonic inflow, free stream": {},
        "supersonic inflow": {"rho": arr(1.0), "vx": arr(1.1 * U_INF),
                              "P": arr(P_INF)},
        "domain interface all": {"rho": 1.01, "vx": arr(U_INF),
                                 "vz": 0.02 * U_INF, "P": P_INF},
        "domain interface rho": {"rho": arr(1.0)},
        # velocity and pressure from the free stream
        "supersonic inflow, density": {"rho": arr(1.0)},
        "mass bleed outflow": {"P": arr(P_INF)},
        "domain interface p": {"P": 0.98 * P_INF},
        "subsonic outflow": {},
        "supersonic outflow": {},
        "extrapolate": {},
    }[kind]


def _bc_name(kind):
    return kind.split(",")[0].upper().replace(" ", "_")


INFLOW = ("subsonic inflow", "subsonic inflow, mass flow",
          "mass bleed inflow", "domain interface total",
          "domain interface rhouvw", "supersonic inflow, free stream",
          "supersonic inflow", "domain interface all",
          "domain interface rho")
OUTFLOW = ("mass bleed outflow", "domain interface p", "supersonic outflow",
           "extrapolate")


def _channel(gen, mesh_mod, inflow, outflow):
    """The channel with its imin face split in j among the ``inflow`` BC
    kinds and its imax face among the ``outflow`` kinds."""
    mesh = gen.channel_mesh(*DIMS)
    blk = mesh.blocks[0]
    nj, nk = DIMS[1], DIMS[2]
    bcs = [sf for sf in blk.bcs if sf.face.name not in ("IMIN", "IMAX")]
    for face, kinds in (("IMIN", inflow), ("IMAX", outflow)):
        cut = np.linspace(0, nj, len(kinds) + 1).astype(int)
        for n, kind in enumerate(kinds):
            j0, j1 = int(cut[n]), int(cut[n + 1])
            bcs.append(mesh_mod.BCSubface(
                getattr(mesh_mod.Face, face),
                getattr(mesh_mod.BCType, _bc_name(kind)),
                family=f"{face.lower()}{n}",
                rng=((j0, j1), (0, nk)),
                data=_data(kind, (j1 - j0, nk), seed=n)))
    blk.bcs = bcs
    return mesh


def _pair(inflow=("subsonic inflow",), outflow=("subsonic outflow",),
          **options):
    """Both packages' Euler channel solvers at the seeded perturbed free
    stream."""
    opts = dict({"equationType": "euler"}, **QUIET, **options)
    js = JaxADFLOW(options=opts, mesh=_channel(jgen, jmesh, inflow, outflow))
    ts = ADFLOW(options=opts, mesh=_channel(tgen, tmesh, inflow, outflow),
                device="cpu")
    js.setAeroProblem(JaxAP(**CHANNEL_AP))
    ts.setAeroProblem(AeroProblem(**CHANNEL_AP))
    w0 = perturbed(np.asarray(js.getStates()), 5)
    js.setStates(w0)
    ts.setStates(w0)
    return js, ts


@pytest.mark.parametrize("kind", INFLOW + OUTFLOW)
def test_fill_halos_match_jax(kind):
    inflow = (kind,) if kind in INFLOW else ("subsonic inflow",)
    outflow = (kind,) if kind in OUTFLOW else ("subsonic outflow",)
    js, ts = _pair(inflow, outflow)
    a = np.asarray(js._filled_w()[0])
    b = ts._filled_w()[0].numpy()
    assert np.all(np.isfinite(b))
    assert np.abs(a - b).max() <= FILL_TOL * np.abs(a).max()
    # the BC wrote its ghosts: they differ from the mirrored interior
    face = 0 if kind in INFLOW else -1
    ghost, mirror = (1, 2) if face == 0 else (-2, -3)
    assert np.abs(b[ghost, 2:-2, 2:-2] - b[mirror, 2:-2, 2:-2]).max() > 0.0 \
        or kind in ("supersonic outflow", "extrapolate")


# the inflow kinds whose ghosts the JAX package computes from float() of
# the free stream, which it cannot trace under jax.jit
FLOAT_OF_WINF = ("subsonic inflow, mass flow", "mass bleed inflow",
                 "supersonic inflow", "domain interface all",
                 "domain interface rho")


@pytest.mark.parametrize("jit", [
    True, pytest.param(False, marks=pytest.mark.slow)],
    ids=["traced", "float"])
def test_residual_derivatives_match_jax(jit):
    """jvp and vjp of the whole residual; imax carries the four outflow
    kinds, imin four inflow kinds the JAX package traces under ``jax.jit``
    (its quicker route), or the five it cannot, run op by op (slow: the
    JAX package's op-by-op jvp and vjp take about 70 s)."""
    inflow = (tuple(k for k in INFLOW if k not in FLOAT_OF_WINF) if jit
              else FLOAT_OF_WINF)
    js, ts = _pair(inflow, OUTFLOW)
    jf = jax_newton.build_newton_fns(js.w_list, js.metrics_list, js.topo,
                                     js.cfg, js.ref, js.winf)
    tf = newton.build_newton_fns(ts.w_list, ts.metrics_list, ts.topo,
                                 ts.cfg, ts.ref, ts.winf)
    w0 = np.asarray(js._wx_vecs()[0])
    rng = np.random.default_rng(4)
    v = rng.standard_normal(w0.shape) * np.abs(w0)
    u = rng.standard_normal(w0.shape)

    def derivs(w, d, c):
        return (jax.jvp(jf.res_flat, (w,), (d,))[1],
                jax.vjp(jf.res_flat, w)[1](c)[0])

    jv_j, vj_j = (jax.jit(derivs) if jit else derivs)(
        jnp.asarray(w0), jnp.asarray(v), jnp.asarray(u))
    w0t = torch.from_numpy(w0)
    jv_t = torch.func.jvp(tf.res_flat, (w0t,), (torch.from_numpy(v),))[1]
    vj_t = torch.func.vjp(tf.res_flat, w0t)[1](torch.from_numpy(u))[0]
    assert rel(jv_j, jv_t.numpy()) < DERIV_TOL
    assert rel(vj_j, vj_t.numpy()) < DERIV_TOL


@pytest.mark.slow
def test_channel_adjoint_vjp_matches_jax():
    """Total-conditions inflow: the free stream's derivatives reach the
    ghosts through ``winf`` (turbulence) and the totals' defaults. Slow
    (7 s on one CPU worker, most of it the JAX package's compile): the
    fast tier holds the BCs' vjp in w in ``test_residual_derivatives_match_jax``
    and a derivative in the flow conditions in
    ``test_free_stream_derivative_kept``."""
    check_residual_vjp(*_pair(), jit=True)


def test_free_stream_derivative_kept():
    """The prescribed-state inflow with a density only: the JAX package
    takes float() of the free stream for the velocity and pressure and
    raises under a derivative in the design variables; the port keeps it a
    tensor. Its jvp in mach equals a central difference of the JAX
    residual (the jvp and vjp in w are held in the slow case of
    ``test_residual_derivatives_match_jax``)."""
    js, ts = _pair(("supersonic inflow, density",))
    jf, tf = js._adjoint_fns(), ts._adjoint_fns()
    wvec, xvec = (np.asarray(v) for v in js._wx_vecs())
    pj = jax_params(js)
    w_t, x_t = torch.tensor(wvec), torch.tensor(xvec)
    with pytest.raises(jax.errors.ConcretizationTypeError):
        jax.vjp(lambda p: jf.res(jnp.asarray(wvec), jnp.asarray(xvec), p),
                pj)
    d = {k: np.zeros_like(v) for k, v in pj.items()}
    # mach only: at alpha 0 the spanwise velocity sits on the kink of |x|
    # (+1 at 0 in both packages' jvps; 0 in a central difference)
    d["mach"] = np.ones(())
    h = 1e-6

    def res_j(sign):
        p = {k: pj[k] + sign * h * d[k] for k in pj}
        return np.asarray(jf.res(jnp.asarray(wvec), jnp.asarray(xvec), p))

    fd = (res_j(1.0) - res_j(-1.0)) / (2.0 * h)
    got = torch.func.jvp(lambda p: tf.res(w_t, x_t, p),
                         (params_from_numpy(pj),),
                         (params_from_numpy(d),))[1]
    assert np.abs(fd).max() > 0.0
    assert rel(fd, got.numpy()) < FD_TOL


@pytest.mark.parametrize("case", [
    "channel", pytest.param("rans_plate", marks=pytest.mark.slow)])
def test_flow_through_functions_match_jax(case):
    """Slow on the plate (the JAX package's RANS set-up, about 30 s): the
    fast tier holds the plate's flow-through functions after four ANK steps
    (tests/test_torch_ank_solve.py)."""
    if case == "channel":
        js, ts = _pair()
    else:
        js, ts = solvers("rans_plate")
        w0 = perturbed(np.asarray(js.getStates()), js.ref.nw)
        js.setStates(w0)
        ts.setStates(w0)
    names = CHANNEL_AP["evalFuncs"] + ["cd"]
    fj = js.evalFunctions(js.curAP, {}, names)
    ft = ts.evalFunctions(ts.curAP, {}, names)
    assert fj.keys() == ft.keys() and len(fj) == len(names)
    for key in fj:
        assert np.isfinite(ft[key])
        assert abs(ft[key] - fj[key]) <= FUNC_TOL * abs(fj[key]), key
    if case == "rans_plate":
        # a real flow-through plane: mass leaves the plate's outflow
        assert ft[f"{ts.curAP.name}_mdot"] < -1e-3
