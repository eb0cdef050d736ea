"""Port parity for geometric FAS multigrid and the full-multigrid start
(solvers/multigrid.py, ADFLOW's multigrid branch and ``_fmg_start``), in
float64 on the CPU:

- ``parse_mg_cycle``; ``coarsen_mesh`` (dims, BC ranges, connection
  offsets and nodes) equal to the JAX package's on the wing (its wrap
  cut), the plate and the channel, over every level;
- ``build_mg_levels`` on the 16x8x8 RANS-SA wing (levels 16x8x8, 8x4x4,
  4x2x2): metrics, restriction volumes and wall distances to 1e-13; every
  level's tensors in the dtype and on the device of the node coordinates;
- the quirk the port keeps: level 0's metrics are ``compute_metrics``'
  (mirrored ghost metrics), not the solver's connected ones, so they
  differ at the O-mesh's ghost entries;
- ``_pool_sum`` on odd dims with semi-coarsening, ``restrict_state``,
  ``restrict_residual``, ``prolong_correction`` and ``_clamped_add`` to
  1e-14;
- one forced RK iteration on a coarse level (``rk_smooth``,
  ``_level_cfg``) to 1e-10; slow: one FAS cycle, '2w' on the RANS-SA wing
  and '2v' and '3v' on the Euler wing, from the seeded perturbed free
  stream: states to 1e-10;
- slow (the JAX package compiles them): ``solve_mg`` through ``ADFLOW``
  (5 cycles, one chunk: '2w' on the RANS-SA wing, '3w' on the Euler wing)
  and the full-multigrid start with the RK smoother on the coarse levels,
  history and states to 1e-9; the start with the default ANK driver, each
  coarse solve held to the JAX package's op-by-op driver.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import adflow_torch.meshgen.analytic as meshgen
import adflow_tpu.meshgen.analytic as jmeshgen
from adflow_torch.solvers import multigrid as mg
from adflow_tpu.solvers import multigrid as jmg
from tests.torch_pairs import perturbed, rel, solvers, variant_pair

# The small wing's coarsest levels (8x4x4, 4x2x2) diverge at the default
# CFLCoarse 1.0 in both packages alike (their free-stream residual is not
# zero: the mirrored ghost metrics at the wrap cut); CFLCoarse 0.25 keeps
# the cycles finite. A '3w' cycle of the RANS-SA wing diverges at any of
# the CFLs tried, so the '3w' parity runs on the Euler wing.
CFL_COARSE = 0.25

MESHES = {
    "wing": ("wing_omesh", dict(ni=16, nj=8, nk=8, viscous=True)),
    "plate": ("flatplate_mesh", dict(ni=16, nj=12)),
    "channel": ("channel_mesh", dict(ni=16, nj=8, nk=2)),
}


def test_parse_mg_cycle():
    for spec in ("sg", "", "none", "1", "2w", "3v", "3w", " 4W "):
        assert mg.parse_mg_cycle(spec) == jmg.parse_mg_cycle(spec)
    assert mg.parse_mg_cycle("3w") == (3, "w")


@pytest.mark.parametrize("name", sorted(MESHES))
def test_coarsen_mesh_matches_jax(name):
    fn, kw = MESHES[name]
    mt, mj = getattr(meshgen, fn)(**kw), getattr(jmeshgen, fn)(**kw)
    n_levels = 0
    while True:
        for bt, bj in zip(mt.blocks, mj.blocks):
            assert bt.dims == bj.dims
            np.testing.assert_array_equal(bt.x, bj.x)
            # the enums are each package's own: compare their names
            assert [(s.face.name, s.bc.name, s.family, s.rng)
                    for s in bt.bcs] == \
                [(s.face.name, s.bc.name, s.family, s.rng) for s in bj.bcs]
            assert [(c.face.name, c.donor_block, c.donor_face.name,
                     c.transform, c.offset, c.rng) for c in bt.conns] == \
                [(c.face.name, c.donor_block, c.donor_face.name,
                  c.transform, c.offset, c.rng) for c in bj.conns]
        try:
            mj = jmg.coarsen_mesh(mj)
        except ValueError:
            with pytest.raises(ValueError):
                mg.coarsen_mesh(mt)
            break
        mt = mg.coarsen_mesh(mt)
        mt.validate()
        n_levels += 1
    assert n_levels >= 1
    if name == "wing":
        assert n_levels == 4 and mt.blocks[0].dims == (1, 1, 1)


@pytest.fixture(scope="module")
def rans():
    return variant_pair("rans_wing")


@pytest.fixture(scope="module")
def rans_levels(rans):
    js, ts = rans.js, rans.ts
    return (jmg.build_mg_levels(js.mesh, js.x_list, js.cfg, 3, js.dtype),
            mg.build_mg_levels(ts.mesh, ts.x_list, ts.cfg, 3))


def test_build_mg_levels_matches_jax(rans_levels):
    lj, lt = rans_levels
    assert [b.dims for lev in lt for b in lev.topo.blocks] == \
        [(16, 8, 8), (8, 4, 4), (4, 2, 2)]
    for a, b in zip(lj, lt):
        assert a.factors == b.factors
        for mj_, mt_ in zip(a.metrics_list, b.metrics_list):
            for f in ("siE", "sjE", "skE", "vol", "xc_ext"):
                assert rel(getattr(mj_, f), getattr(mt_, f).numpy()) < 1e-13
        for vj, vt in zip(a.vols, b.vols):
            assert rel(vj, vt.numpy()) < 1e-13
        for ej, et in zip(a.extras_list, b.extras_list):
            assert rel(ej["walldist"], et["walldist"].numpy()) < 1e-13
        for bj, bt in zip(a.topo.blocks, b.topo.blocks):
            for pj, pt in zip(bj.por, bt.por):
                np.testing.assert_array_equal(np.asarray(pj), pt.numpy())


def test_level_zero_is_not_the_solvers_metrics(rans, rans_levels):
    """As in the JAX package, multigrid's level 0 takes per-block
    ``compute_metrics`` (mirrored ghosts at the wrap cut) and wall
    distances without the cutoff; the solver's own metrics are the
    connected ones. They differ at ghost entries and agree inside."""
    ts = rans.ts
    m_lev, m_sol = rans_levels[1][0].metrics_list[0], ts.metrics_list[0]
    for f in ("siE", "vol", "xc_ext"):
        a, b = getattr(m_lev, f), getattr(m_sol, f)
        assert float(torch.abs(a - b).max()) > 1e-3 * float(
            torch.abs(b).max()), f
    it = (slice(2, -2),) * 3
    assert torch.equal(m_lev.vol[it], m_sol.vol[it])


def test_levels_take_the_solvers_dtype_and_device(rans):
    """Every level's topology, metrics, wall distances and volumes come in
    the dtype and on the device of the node coordinates (float32 here, as
    the card's solver gives them)."""
    ts = rans.ts
    x32 = [x.to(torch.float32) for x in ts.x_list]
    levels = mg.build_mg_levels(ts.mesh, x32, ts.cfg, 3)
    for lev in levels:
        tensors = [t for m in lev.metrics_list for t in m if t is not None]
        tensors += [e["walldist"] for e in lev.extras_list]
        tensors += list(lev.vols)
        tensors += [p for b in lev.topo.blocks for p in b.por]
        for t in tensors:
            assert t.dtype == torch.float32
            assert t.device == x32[0].device


@pytest.mark.parametrize("shape,f", [((16, 8, 1, 5), (2, 2, 1)),
                                     ((16, 12, 2, 5), (2, 2, 2)),
                                     ((6, 5, 4, 6), (2, 1, 2))])
def test_transfers_match_jax(shape, f):
    rng = np.random.default_rng(4)
    a = rng.standard_normal(shape)
    assert rel(jmg._pool_sum(jnp.asarray(a), f),
               mg._pool_sum(torch.from_numpy(a), f).numpy()) < 1e-14
    assert rel(jmg.restrict_residual(jnp.asarray(a), f),
               mg.restrict_residual(torch.from_numpy(a), f).numpy()) < 1e-14
    cshape = tuple(n // fa for n, fa in zip(shape[:3], f)) + shape[3:]
    c = rng.standard_normal(cshape)
    assert rel(jmg.prolong_correction(jnp.asarray(c), f),
               mg.prolong_correction(torch.from_numpy(c), f).numpy()) < 1e-14
    wpad = rng.uniform(0.5, 1.5, tuple(n + 4 for n in shape[:3])
                       + shape[3:])
    vol_f = rng.uniform(0.5, 1.5, shape[:3])
    vol_c = jmg._pool_sum(jnp.asarray(vol_f)[..., None], f)[..., 0]
    want = jmg.restrict_state(jnp.asarray(wpad), jnp.asarray(vol_f), vol_c,
                              f)
    got = mg.restrict_state(torch.from_numpy(wpad), torch.from_numpy(vol_f),
                            torch.tensor(np.asarray(vol_c)), f)
    assert got.shape == want.shape and rel(want, got.numpy()) < 1e-14
    cor = 0.5 * rng.standard_normal(shape)
    assert rel(jmg._clamped_add(jnp.asarray(wpad), jnp.asarray(cor)),
               mg._clamped_add(torch.from_numpy(wpad),
                               torch.from_numpy(cor)).numpy()) < 1e-14


def test_forced_rk_smooth_matches_jax():
    """One forced RK iteration (``rk_smooth``: five stages of the
    coarse-level scheme with a seeded FAS forcing, ``_level_cfg``) on the
    Euler wing's 8x4x4 level, from its restriction of the seeded perturbed
    state: 1e-10. The JAX side op by op, without residual averaging (its
    line solves compile again at every call)."""
    pair = variant_pair("euler_wing")
    js, ts = pair.js, pair.ts
    lj = jmg.build_mg_levels(js.mesh, js.x_list, js.cfg, 2, js.dtype)
    lt = mg.build_mg_levels(ts.mesh, ts.x_list, ts.cfg, 2)
    f = lt[0].factors[0]
    w_c = mg.restrict_state(pair.wt[0], lt[0].vols[0], lt[1].vols[0], f)
    forcing = 1e-3 * np.random.default_rng(8).standard_normal(
        tuple(n - 4 for n in w_c.shape[:3]) + (5,))
    cj, ct = jmg._level_cfg(js.cfg, 1), mg._level_cfg(ts.cfg, 1)
    assert ct.coarse_level and ct.vis2 == cj.vis2 == mg.VIS2_COARSE
    wj, rj = jmg.rk_smooth([jnp.asarray(w_c.numpy())], lj[1], cj, js.ref,
                           js.winf, 0.5, [jnp.asarray(forcing)])
    wt, rt = mg.rk_smooth([w_c], lt[1], ct, ts.ref, ts.winf, 0.5,
                          [torch.from_numpy(forcing)])
    assert rel(rj[0], rt[0].numpy()) < 1e-10
    assert rel(np.asarray(wj[0])[2:-2, 2:-2, 2:-2],
               wt[0][2:-2, 2:-2, 2:-2].numpy()) < 1e-10


@pytest.mark.parametrize("case,spec,irs_eps", [
    pytest.param("euler_wing", "2v", 0.0, marks=pytest.mark.slow),
    pytest.param("euler_wing", "3v", 0.0, marks=pytest.mark.slow),
    pytest.param("euler_wing", "3v", 0.5, marks=pytest.mark.slow),
    pytest.param("rans_wing", "2w", 0.5, marks=pytest.mark.slow)])
def test_fas_cycle_matches_jax(case, spec, irs_eps):
    """One cycle from the seeded perturbed free stream. The JAX side runs
    op by op (its compile of a cycle takes longer); with residual
    averaging its line solves (``lax.scan``s) compile again at every call.
    Slow: 40 s to 2 min each."""
    pair = variant_pair(case)
    js, ts = pair.js, pair.ts
    n, ctype = mg.parse_mg_cycle(spec)
    lj = jmg.build_mg_levels(js.mesh, js.x_list, js.cfg, n, js.dtype)
    lt = mg.build_mg_levels(ts.mesh, ts.x_list, ts.cfg, n)
    kw = dict(cycle=ctype, irs_eps=irs_eps, cfl_coarse=CFL_COARSE)
    wj, rj = jmg.fas_cycle(js.w_list, lj, js.cfg, js.ref, js.winf, 1.7, **kw)
    wt, rt = mg.fas_cycle(ts.w_list, lt, ts.cfg, ts.ref, ts.winf, 1.7, **kw)
    for a, b in zip(rj, rt):
        assert rel(a, b.numpy()) < 1e-10
    for a, b in zip(wj, wt):
        a, b = np.asarray(a)[2:-2, 2:-2, 2:-2], b[2:-2, 2:-2, 2:-2].numpy()
        for c in range(a.shape[-1]):
            assert rel(a[..., c], b[..., c]) < 1e-10, c
    assert rel(pair.w0.reshape(a.shape), b) > 1e-6


def _check_solves(js, ts, n):
    hj, ht = js.solve_info.history, ts.solve_info.history
    assert hj.shape == ht.shape == (n, 2)
    assert js.solve_info.iterations == ts.solve_info.iterations == n
    assert np.all(np.isfinite(ht))
    for c in range(2):
        assert rel(hj[:, c], ht[:, c]) < 1e-9, c
    assert rel(np.asarray(js.getStates()), ts.getStates().numpy()) < 1e-9
    fj = js.evalFunctions(js.curAP, {})
    ft = ts.evalFunctions(ts.curAP, {})
    for k in fj:
        assert abs(fj[k] - ft[k]) <= 1e-9 * abs(fj[k]), k


@pytest.mark.slow
@pytest.mark.parametrize("case,spec", [("rans_wing", "2w"),
                                       ("euler_wing", "3w")])
def test_solve_mg_matches_jax(case, spec):
    """5 cycles (one chunk) through ``ADFLOW`` from the perturbed free
    stream (no full-multigrid start: MGStartLevel 1). Slow: the JAX
    package compiles the chunk, 2 to 3 min."""
    opts = dict(MGCycle=spec, MGStartLevel=1, useANKSolver=False,
                useNKSolver=False, nCycles=5, CFLCoarse=CFL_COARSE)
    js, ts = solvers(case, **opts)
    w0 = perturbed(np.asarray(js.getStates()), ts.ref.nw)
    js.setStates(w0)
    ts.setStates(w0)
    js(js.curAP)
    ts(ts.curAP)
    _check_solves(js, ts, 5)


def _fmg_pair(**options):
    """Both packages' fresh Euler-wing solvers after the full-multigrid
    start of '3v' (levels 8x4x4 and 4x2x2 solved, prolonged to 16x8x8)."""
    opts = dict(MGCycle="3v", nCyclesCoarse=25, CFLCoarse=CFL_COARSE,
                **options)
    js, ts = solvers("euler_wing", **opts)
    js._fmg_start(js.options)
    ts._fmg_start(ts.options)
    want, got = np.asarray(js.getStates()), ts.getStates().numpy()
    assert rel(want, got) < 1e-9
    # the start moved the free stream, and only the fine level remains
    assert rel(np.asarray(js.winf)[None], got.reshape(-1, 5)) > 1e-4
    assert len(ts.fmg_info) == 2
    assert not any(i.failed for i in ts.fmg_info)
    return js, ts


@pytest.mark.slow
def test_fmg_start_rk_matches_jax():
    """The full-multigrid start with the RK smoother on the coarse levels
    (useANKSolver off), then 5 '3v' cycles through ``ADFLOW``. Slow: the
    JAX package compiles an RK chunk a level and the cycles' chunk."""
    js, ts = _fmg_pair(useANKSolver=False, useNKSolver=False, nCycles=5)
    assert [i.iterations for i in ts.fmg_info] == [25, 25]
    for s in (js, ts):
        s._fresh_state = False   # the start is done
        s(s.curAP)
    _check_solves(js, ts, 5)


@pytest.mark.slow
def test_fmg_start_ank_matches_jax(monkeypatch):
    """The full-multigrid start as the defaults run it: the ANK driver on
    the coarse levels. The coarsest level starts from its exact free
    stream, where the JAX package's results follow the rounding of the
    JST sensor's kink (its compiled steps, its op-by-op ones and its start
    under ``jax.disable_jit`` give three first steps 4% apart;
    tests/torch_pairs.py). So each of the port's coarse Newton solves is
    held to the JAX package's op-by-op driver from the same level state
    and data, and the port's final state to the JAX package's
    prolongation of its last level. The coarsest level's solve agrees to
    1e-9. The next starts from the piecewise-constant prolongation, whose
    2x2x2 groups of equal states put the sensor on its kink again in many
    cells: there the two op-by-op evaluations part by 4.9e-7 (measured),
    so that level is held to 1e-6."""
    from adflow_torch.solvers import newton
    from adflow_tpu.solvers import newton as jnewton

    js, ts = solvers("euler_wing", MGCycle="3v", nCyclesCoarse=25,
                     CFLCoarse=CFL_COARSE)
    calls = []
    driver = newton.solve_newton_driver

    def recording(w_list, *args, **kw):
        out = driver(w_list, *args, **kw)
        calls.append(([w.clone() for w in w_list], out))
        return out

    monkeypatch.setattr(newton, "solve_newton_driver", recording)
    ts._fmg_start(ts.options)
    assert len(calls) == 2 and not any(c[1][1].failed for c in calls)
    lj = jmg.build_mg_levels(js.mesh, js.x_list, js.cfg, 3, js.dtype)
    sub = js.options.asdict()
    sub.update(nCycles=25, L2Convergence=float(
        js.options["L2ConvergenceCoarse"]), printIterations=False)
    for (w_in, (w_out, info)), lev, tol in zip(calls, (2, 1), (1e-9, 1e-6)):
        level = lj[lev]
        with jax.disable_jit():
            wj, ij = jnewton.solve_newton_driver(
                [jnp.asarray(w.numpy()) for w in w_in],
                list(level.metrics_list), level.topo, js.cfg, js.ref,
                js.winf, sub)
        assert rel(ij.history, info.history) < tol, lev
        assert rel(np.asarray(wj[0])[2:-2, 2:-2, 2:-2],
                   w_out[0][2:-2, 2:-2, 2:-2].numpy()) < tol, lev
    want = jmg.prolong_correction(
        jnp.asarray(calls[-1][1][0][0][2:-2, 2:-2, 2:-2].numpy()),
        lj[0].factors[0])
    assert rel(want, ts.w_list[0][2:-2, 2:-2, 2:-2].numpy()) < 1e-14
    assert all(len(c[1][1].steps) > 0 for c in calls)
