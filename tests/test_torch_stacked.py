"""The stacked multi-block layout (adflow_torch/dist/stacked.py,
dist/comm.py and the stacked half of dist/halo.py) against the JAX
package's, in float64 on the CPU, and across gloo ranks against one
device.

- ``split_block``, ``balance_blocks`` and ``build_stacked_problem`` give
  the same meshes, orders, buckets, porosities, masks and halo tables:
  the wing of tests/test_stacked.py and the NACA 0012 over 4, the cube over
  8, the cross-block donor remap and an uneven split with a dummy slot.
  The JAX package's table for the cube lists 640 ghost cells more than
  once (3,072 entries for 2,368 cells), with different donors; its
  exchange on the CPU keeps the last entry, and the port's table is that
  table with each ghost cell once.
- The exchange is bitwise equal; the residual (Euler and RANS-SA) agrees
  to 1e-12 of the flux scale and its jvp to 1e-10; two RK steps to 1e-10;
  one ANK step to 1e-10 (slow: the JAX side compiles the whole step);
  ``checkPartitioning`` is equal.
- On gloo groups of 2 (Euler, and the cube with a dummy slot) and 4
  (RANS-SA) ranks, spawned once for the module (tests/torch_dist.py), against one device: the exchange and its
  jvp bitwise, its backward by the dot-product identity to 1e-12, the
  residual to 1e-12, the RK steps, the ANK step and a GMRES solve over
  the group to 1e-10.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import adflow_torch.meshgen.analytic as tmg
import adflow_tpu.meshgen.analytic as jmg
import torch_dist as td
from adflow_torch.dist import comm
from adflow_torch.dist import halo as thalo
from adflow_torch.dist import stacked as ts
from adflow_tpu.dist import halo as jhalo
from adflow_tpu.dist import stacked as js

RES_TOL = 1e-12
JVP_TOL = 1e-10
STEP_TOL = 1e-10


def _case(analytic, stacked, name):
    """(mesh, order) of a named case in one package."""
    if name == "wing4":
        return stacked.balance_blocks(analytic.wing_omesh(32, 12, 8), 4)
    if name == "naca4":
        return stacked.balance_blocks(analytic.naca0012_omesh(48, 16), 4)
    if name == "cube8":
        return stacked.balance_blocks(analytic.cube_mesh(n=8), 8)
    if name == "remap":
        m = stacked.split_block(analytic.wing_omesh(32, 12, 8), 0, 2, 4)
        return stacked.split_block(m, 0, 1, 6), None
    if name == "dummy":
        return stacked.balance_blocks(
            stacked.split_block(analytic.cube_mesh(n=6), 0, 0, 2), 2)
    raise KeyError(name)


CASES = ["wing4", "naca4", "cube8", "remap", "dummy"]


def _pair(name):
    jm, jo = _case(jmg, js, name)
    tm, to = _case(tmg, ts, name)
    return (jm, jo, js.build_stacked_problem(jm, jo),
            tm, to, ts.build_stacked_problem(tm, to))


def _same_mesh(jm, tm):
    assert len(jm.blocks) == len(tm.blocks)
    for jb, tb in zip(jm.blocks, tm.blocks):
        assert jb.name == tb.name and np.array_equal(jb.x, tb.x)
        assert [(int(s.face), s.bc.name, s.family, s.rng, s.data)
                for s in jb.bcs] == [(int(s.face), s.bc.name, s.family,
                                      s.rng, s.data) for s in tb.bcs]
        assert [(int(c.face), c.donor_block, int(c.donor_face), c.transform,
                 c.offset, c.rng, c.rotation) for c in jb.conns] == [
            (int(c.face), c.donor_block, int(c.donor_face), c.transform,
             c.offset, c.rng, c.rotation) for c in tb.conns]


def _jax_kept(jp):
    """The entries of the JAX package's table that its exchange keeps on
    the CPU: run it on a stack whose cells hold their own global index and
    read which donor each ghost cell got."""
    h = jp.halo
    n_pad = int(np.prod(h.padded_shape))
    nb = jp.nb
    field = np.arange(nb * n_pad, dtype=np.float64).reshape(
        (nb,) + tuple(h.padded_shape) + (1,))
    got = np.asarray(jhalo.exchange_halos(jnp.asarray(field), h)).reshape(-1)
    src = h.src_block.astype(np.int64) * n_pad + h.src_flat
    dst = h.dst_block.astype(np.int64) * n_pad + h.dst_flat
    match = np.nonzero(got[dst] == src)[0]
    kept = match[thalo._last_of_each(dst[match])]
    assert len(np.unique(dst)) == len(kept)
    return kept


@pytest.mark.parametrize("name", CASES)
def test_split_balance_and_tables_match_jax(name):
    jm, jo, jp, tm, to, tp = _pair(name)
    _same_mesh(jm, tm)
    assert jo == to and jp.order == tp.order
    assert (jp.nb, jp.bucket, jp.block_dims, jp.active) == (
        tp.nb, tp.bucket, tp.block_dims, tp.active)
    for a, b in zip(jp.por, tp.por):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert np.array_equal(jp.mask, tp.mask)
    assert len(jp.bc_ops) == len(tp.bc_ops)
    for jo_, to_ in zip(jp.bc_ops, tp.bc_ops):
        assert [(o.bc.name, o.axis, o.is_high, o.ghost, o.mirror, o.face_sl,
                 o.pad, o.sign) for o in jo_] == [
            (o.bc.name, o.axis, o.is_high, o.ghost, o.mirror, o.face_sl,
             o.pad, o.sign) for o in to_]
    kept = _jax_kept(jp)
    for f in ("dst_block", "dst_flat", "src_block", "src_flat", "rot"):
        assert np.array_equal(getattr(jp.halo, f)[kept],
                              getattr(tp.halo, f)), f
    assert np.array_equal(jp.halo.rotations, tp.halo.rotations)
    assert jp.halo.padded_shape == tp.halo.padded_shape
    key = tp.halo.dst_block.astype(np.int64) * 10 ** 9 + tp.halo.dst_flat
    assert len(np.unique(key)) == len(key)
    if name == "cube8":
        jkey = jp.halo.dst_block.astype(np.int64) * 10 ** 9 + jp.halo.dst_flat
        _, counts = np.unique(jkey, return_counts=True)
        assert (len(jkey), int((counts > 1).sum()), len(key)) == (
            3072, 640, 2368)
    if name == "dummy":
        assert [b.dims for b in tm.blocks] == [(2, 6, 6), (4, 3, 6),
                                               (4, 3, 6)]
        assert to == [2, 0, 1, -1] and tp.bucket == (4, 6, 6)


@pytest.mark.parametrize("name", CASES)
def test_exchange_matches_jax_bitwise(name):
    _, _, jp, _, _, tp = _pair(name)
    rng = np.random.default_rng(0)
    w = rng.standard_normal((jp.nb,) + tuple(jp.halo.padded_shape) + (5,))
    want = np.asarray(jhalo.exchange_halos(jnp.asarray(w), jp.halo))
    got = thalo.exchange_halos(torch.as_tensor(w), tp.halo).numpy()
    assert np.array_equal(want, got)
    assert np.array_equal(want, comm.exchange(torch.as_tensor(w),
                                              tp.plan).numpy())


def _jax_case(case):
    """The JAX package's side of torch_dist.stacked_case."""
    from adflow_tpu.core.refstate import AeroProblem, make_reference_state
    from adflow_tpu.geom.walldist import compute_wall_distances
    from adflow_tpu.physics.residual import ProblemConfig

    equation_type = "euler" if case == "dummy" else case
    viscous = equation_type != "euler"
    if case == "dummy":
        mesh, order = _case(jmg, js, "dummy")
        ap = AeroProblem(name="c", mach=0.4, alpha=1.0)
    else:
        mesh, order = js.balance_blocks(
            jmg.wing_omesh(*td.STACKED_DIMS, viscous=viscous), 4)
        ap = AeroProblem(name="w", mach=0.6, alpha=2.0,
                         reynolds=(1e6 if viscous else None))
    cfg = ProblemConfig(
        equation_type=equation_type, vis2=0.25, vis4=1.0 / 64.0,
        diss_exponent=0.67, turbulence_model="sa",
        turb_res_scale=(1e4 if equation_type == "rans" else 1.0))
    ref = make_reference_state(ap, lift_index=2, n_turb=cfg.n_turb)
    winf = jnp.asarray(ref.winf())
    prob = js.build_stacked_problem(mesh, order)
    sm = js.stack_metrics(mesh, prob, jnp.float64)
    extras = None
    if cfg.rans:
        xs = [jnp.asarray(b.x) for b in mesh.blocks]
        extras = {"walldist": js.stack_walldist(
            mesh, prob, compute_wall_distances(mesh, xs, jnp.float64),
            jnp.float64)}
    return mesh, prob, cfg, ref, winf, sm, extras


def _flux_scale(w, sm):
    """Largest |p| times the largest face area of the stack."""
    p = 0.4 * (w[..., 4] - 0.5 * np.sum(w[..., 1:4] ** 2, axis=-1)
               / w[..., 0])
    s = max(float(torch.linalg.norm(a, dim=-1).max())
            for a in (sm.siE, sm.sjE, sm.skE))
    return float(np.abs(p).max()) * s


@pytest.mark.parametrize("case", [
    "euler", "rans", pytest.param("dummy", marks=pytest.mark.slow)])
def test_stacked_residual_and_jvp_match_jax(case):
    """The residual and its jvp at a seeded state; the cube with a dummy
    slot is slow (the JAX side's compile of its many BC passes takes
    35 s), its port side is held across ranks below."""
    _, jp, jc, jr, jw, jsm, jex = _jax_case(case)
    c = td.stacked_case(case)
    w0 = td.seeded_stack(c).numpy()
    t0 = (td.seeded_stack(c, seed=1).numpy() - w0)

    def jres(w):
        return js.stacked_residual(w, jsm, jp, jc, jr, jw, jex)

    # one compile: the jvp's primal is the residual
    want, want_t = (np.asarray(a) for a in jax.jit(
        lambda w, t: jax.jvp(jres, (w,), (t,)))(jnp.asarray(w0),
                                                 jnp.asarray(t0)))

    def tres(w):
        return ts.stacked_residual(w, c.sm, c.prob, c.cfg, c.ref, c.winf,
                                   c.extras)

    got = tres(torch.as_tensor(w0)).numpy()
    _, got_t = torch.func.jvp(tres, (torch.as_tensor(w0),),
                              (torch.as_tensor(t0),))
    err = np.abs(want - got).max() / _flux_scale(w0, c.sm)
    assert err < RES_TOL, err
    scale = np.abs(want_t).max(axis=(0, 1, 2, 3)) + 1e-300
    err_t = (np.abs(want_t - got_t.numpy()).max(axis=(0, 1, 2, 3))
             / scale).max()
    assert err_t < JVP_TOL, err_t


@pytest.mark.parametrize("case", [
    "euler", pytest.param("rans", marks=pytest.mark.slow),
    pytest.param("dummy", marks=pytest.mark.slow)])
def test_stacked_rk_matches_jax(case):
    """Two RK steps from a seeded state; RANS-SA and the cube with a dummy
    slot are slow (the JAX step's compile), their port sides are held
    across ranks below."""
    _, jp, jc, jr, jw, jsm, jex = _jax_case(case)
    c = td.stacked_case(case)
    rk = jax.jit(js.make_stacked_rk_step(jp, jc, jr, cfl=1.0))
    step = ts.make_stacked_rk_step(c.prob, c.cfg, c.ref, cfl=1.0)
    wt = td.seeded_stack(c)
    wj = jnp.asarray(wt.numpy())
    for _ in range(2):
        wj, nj = rk(wj, jsm, jw, jex)
        wt, nt = step(wt, c.sm, c.winf, c.extras)
    wj = np.asarray(wj)
    assert np.abs(wj - wt.numpy()).max() / np.abs(wj).max() < STEP_TOL
    nj = np.asarray(nj)
    assert np.abs(nj - nt.numpy()).max() / np.abs(nj).max() < STEP_TOL


@pytest.mark.slow
@pytest.mark.parametrize("case", ["euler", "rans", "dummy"])
def test_stacked_ank_matches_jax(case):
    """One ANK step at CFL 5 from a seeded state, the JAX side under one
    ``jax.jit`` (about a minute to compile)."""
    _, jp, jc, jr, jw, jsm, jex = _jax_case(case)
    c = td.stacked_case(case)
    w0 = td.seeded_stack(c).numpy()
    out = jax.jit(lambda w: js.stacked_ank_step(
        w, jsm, jp, jc, jr, jw, jnp.asarray(5.0), extras=jex))(
        jnp.asarray(w0))
    got = ts.stacked_ank_step(torch.as_tensor(w0), c.sm, c.prob, c.cfg,
                              c.ref, c.winf, 5.0, extras=c.extras)
    want = np.asarray(out[0])
    assert np.abs(want - got[0].numpy()).max() / np.abs(want).max() \
        < STEP_TOL
    stats_j = np.array([float(x) for x in out[1:]])
    stats_t = np.array(got[1:], dtype=float)
    assert np.abs(stats_j - stats_t).max() / np.abs(stats_j).max() \
        < STEP_TOL


@pytest.fixture(scope="module")
def solvers_pair():
    from adflow_torch.api.solver import ADFLOW
    from adflow_tpu.api.solver import ADFLOW as JaxADFLOW

    opts = {"equationType": "euler", "printIterations": False}
    return (JaxADFLOW(options=opts, mesh=jmg.wing_omesh(32, 12, 8)),
            ADFLOW(options=opts, mesh=tmg.wing_omesh(32, 12, 8),
                   device="cpu"))


@pytest.mark.parametrize("nprocs", [2, 4, 8])
def test_check_partitioning_matches_jax(solvers_pair, nprocs):
    jsolver, tsolver = solvers_pair
    assert tsolver.checkPartitioning(nprocs) == jsolver.checkPartitioning(
        nprocs)


# ---------------------------------------------------------------------------
# across gloo ranks, against one device
# ---------------------------------------------------------------------------

WORLDS = [(2, "euler"), (4, "rans"), (2, "dummy")]
IDS = ["2-euler", "4-rans", "2-dummy"]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Both worlds started together; the one-device references computed
    meanwhile in this process."""
    tmp = tmp_path_factory.mktemp("stacked_worlds")
    worlds = {k: td.World(k[0], "stacked_results", tmp, k[1])
              for k in WORLDS}
    ref = {eq: td.stacked_results(None, eq) for _, eq in WORLDS}
    return ref, {k: w.result() for k, w in worlds.items()}


def _rel(a, b):
    a, b = np.asarray(a, float), np.asarray(b, float)
    return np.abs(a - b).max() / (np.abs(a).max() + 1e-300)


@pytest.mark.parametrize("world", WORLDS, ids=IDS)
def test_ranks_exchange_bitwise(ranks, world):
    ref, got = ranks
    assert np.array_equal(ref[world[1]]["exchange"], got[world]["exchange"])


@pytest.mark.parametrize("world", WORLDS, ids=IDS)
def test_ranks_exchange_jvp_and_transpose(ranks, world):
    """The exchange's jvp is the exchange of the tangent, and its backward
    is its transpose: <E t, u> = <t, E^T u> summed over the ranks."""
    ref, got = ranks
    r, g = ref[world[1]], got[world]
    assert _rel(r["exchange_jvp"], g["exchange_jvp"]) < RES_TOL
    for res in (r, g):
        assert abs(res["dot_forward"] - res["dot_backward"]) \
            < RES_TOL * abs(res["dot_forward"])


@pytest.mark.parametrize("world", WORLDS, ids=IDS)
def test_ranks_residual(ranks, world):
    ref, got = ranks
    assert _rel(ref[world[1]]["residual"], got[world]["residual"]) < RES_TOL


@pytest.mark.parametrize("world", WORLDS, ids=IDS)
def test_ranks_rk_steps(ranks, world):
    ref, got = ranks
    r, g = ref[world[1]], got[world]
    assert _rel(r["rk"], g["rk"]) < STEP_TOL
    assert _rel(r["rk_norms"], g["rk_norms"]) < STEP_TOL


@pytest.mark.parametrize("world", WORLDS, ids=IDS)
def test_ranks_ank_step(ranks, world):
    ref, got = ranks
    r, g = ref[world[1]], got[world]
    assert _rel(r["ank"], g["ank"]) < STEP_TOL
    assert _rel(r["ank_stats"], g["ank_stats"]) < STEP_TOL
    assert g["ank_stats"][1] < g["ank_stats"][0]


@pytest.mark.parametrize("world", WORLDS, ids=IDS)
def test_ranks_gmres(ranks, world):
    ref, got = ranks
    r, g = ref[world[1]], got[world]
    assert r["gmres_iters"] == g["gmres_iters"]
    assert _rel(r["gmres"], g["gmres"]) < STEP_TOL
