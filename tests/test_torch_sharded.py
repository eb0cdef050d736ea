"""The k-split of one block over ranks (adflow_torch/dist/sharded.py,
sharded_newton.py and dist/comm.py's ``KRing``) against the JAX package's
k-split under ``shard_map`` on four virtual CPU devices, and across gloo
ranks against one rank, in float64.

- ``exchange_k_halos`` on 4 ranks is bitwise the JAX package's ``ppermute``
  ring; its jvp and its backward (the reversed ring) satisfy the
  dot-product identity to 1e-12.
- Three RK iterations of the 32x12x8 wing (Euler and RANS-SA) on 4 ranks
  agree with the JAX package's 4-shard step to 1e-12 (tests/test_sharded.py
  holds that step to the single-block path to 1e-12).
- One distributed ANK step with the adjoint matvec's norm, from a seeded
  state, on 2 (Euler) and 4 ranks against one rank, to 1e-8
  (tests/test_sharded.py's bound); against the JAX package's step it is
  slow (the JAX side's compile). From the exact free stream the step sits
  on the JST sensor's kink, where the JAX package's own compiled and
  op-by-op steps differ in the third digit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

import torch_dist as td
from adflow_tpu.dist import sharded as jsh

RK_TOL = 1e-12
ANK_TOL = 1e-8
N_SHARDS = 4
WORLDS = [(4, "euler"), (4, "rans"), (2, "euler")]
IDS = ["4-euler", "4-rans", "2-euler"]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Each world in turn, the one-rank references computed meanwhile."""
    tmp = tmp_path_factory.mktemp("sharded_worlds")
    ref, got = {}, {}
    for n, eq in WORLDS:
        world = td.World(n, "sharded_results", tmp, eq)
        if eq not in ref:
            ref[eq] = td.sharded_results(None, eq)
        got[(n, eq)] = world.result()
    return ref, got


def _jax_setup(equation_type):
    from adflow_tpu.core.refstate import AeroProblem, make_reference_state
    from adflow_tpu.geom.walldist import compute_wall_distances
    from adflow_tpu.meshgen.analytic import wing_omesh
    from adflow_tpu.physics.residual import ProblemConfig

    viscous = equation_type != "euler"
    mesh = wing_omesh(*td.STACKED_DIMS, viscous=viscous)
    cfg = ProblemConfig(equation_type=equation_type, vis2=0.25,
                        vis4=1.0 / 64.0, diss_exponent=0.67,
                        turbulence_model="sa")
    ap = AeroProblem(name="w", mach=0.6, alpha=2.0,
                     reynolds=(1e6 if viscous else None))
    ref = make_reference_state(ap, lift_index=2, n_turb=cfg.n_turb)
    winf = jnp.asarray(ref.winf())
    x = jnp.asarray(mesh.blocks[0].x)
    d = compute_wall_distances(mesh, [x], x.dtype)[0] if cfg.rans else None
    return mesh, cfg, ref, winf, x, d


def _jax_sharded(equation_type, make_step, seeded=False):
    """The JAX package's 4-shard step from ``make_step(prob, cfg, ref,
    device_mesh)`` on the free stream, or on torch_dist.seeded_shards:
    (global interior, its stats)."""
    from adflow_tpu.geom.metrics import compute_metrics

    mesh, cfg, ref, winf, x, d = _jax_setup(equation_type)
    dm = Mesh(np.array(jax.devices()[:N_SHARDS]), axis_names=("z",))
    prob = jsh.build_sharded_problem(mesh, n_shards=N_SHARDS)
    w_st, d_st = jsh.shard_arrays(mesh, prob, winf, x.dtype,
                                  None if d is None else np.asarray(d))
    if seeded:
        w_st = jnp.asarray(td.seeded_shards(winf, mesh, N_SHARDS))
    m_st = jsh.split_metrics(compute_metrics(x), N_SHARDS)
    sh = NamedSharding(dm, P("z"))
    w_st, m_st = jax.device_put(w_st, sh), jax.device_put(m_st, sh)
    if d_st is not None:
        d_st = jax.device_put(d_st, sh)
    step = jax.jit(make_step(prob, cfg, ref, dm))
    w_new, stats = step(w_st, m_st, jnp.asarray(winf), d_st)
    w_np = np.asarray(w_new)[:, 2:-2, 2:-2, 2:-2]
    return np.concatenate(list(w_np), axis=2), np.asarray(stats)


def _rel(a, b):
    """Largest difference over each variable's field scale."""
    scale = np.maximum(np.abs(a).max(axis=(0, 1, 2)), 1e-12)
    return np.max(np.abs(a - b) / scale)


def test_k_ring_matches_jax(ranks):
    got = ranks[1][(4, "euler")]["ring"]
    w = got["w"]
    dm = Mesh(np.array(jax.devices()[:N_SHARDS]), axis_names=("z",))
    ring = jax.jit(jsh.shard_map(
        lambda v: jsh.exchange_k_halos(v[0], "z")[None], mesh=dm,
        in_specs=P("z"), out_specs=P("z")))
    want = np.asarray(ring(jax.device_put(jnp.asarray(w),
                                          NamedSharding(dm, P("z")))))
    assert np.array_equal(want, got["out"])
    assert abs(got["dot_forward"] - got["dot_backward"]) \
        < RK_TOL * abs(got["dot_forward"])


@pytest.mark.parametrize("equation_type", ["euler", "rans"])
def test_sharded_rk_matches_jax(ranks, equation_type):
    want, hist = _jax_sharded(
        equation_type,
        lambda prob, cfg, ref, dm: jsh.make_sharded_step(
            prob, cfg, ref, dm, n_iters=3, cfl=1.0))
    got = ranks[1][(N_SHARDS, equation_type)]
    assert np.all(np.isfinite(got["rk"]))
    assert _rel(want, got["rk"]) < RK_TOL
    assert np.abs(hist - got["rk_hist"]).max() < RK_TOL * np.abs(hist).max()


@pytest.mark.parametrize("world", WORLDS, ids=IDS)
def test_sharded_rk_across_ranks(ranks, world):
    ref, got = ranks
    assert _rel(ref[world[1]]["rk"], got[world]["rk"]) < RK_TOL


@pytest.mark.parametrize("world", WORLDS, ids=IDS)
def test_sharded_ank_adjoint_across_ranks(ranks, world):
    """The distributed ANK step and the adjoint matvec's norm against one
    rank (GMRES reduces in another order across ranks, so not bitwise)."""
    ref, got = ranks
    r, g = ref[world[1]], got[world]
    assert np.all(np.isfinite(g["ank"])) and np.all(np.isfinite(
        g["ank_stats"]))
    assert _rel(r["ank"], g["ank"]) < ANK_TOL
    assert abs(r["ank_stats"][3] - g["ank_stats"][3]) \
        < ANK_TOL * abs(r["ank_stats"][3])
    assert g["ank_stats"][1] < g["ank_stats"][0]


@pytest.mark.slow
@pytest.mark.parametrize("equation_type", ["euler", "rans"])
def test_sharded_ank_adjoint_matches_jax(ranks, equation_type):
    from adflow_tpu.dist.sharded_newton import make_sharded_ank_adjoint_step

    want, stats = _jax_sharded(
        equation_type,
        lambda prob, cfg, ref, dm: make_sharded_ank_adjoint_step(
            prob, cfg, ref, dm, cfl=5.0), seeded=True)
    got = ranks[1][(N_SHARDS, equation_type)]
    assert _rel(want, got["ank"]) < ANK_TOL
    assert np.abs(stats - got["ank_stats"]).max() \
        < ANK_TOL * np.abs(stats).max()
