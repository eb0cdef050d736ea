"""Geometric multigrid (FAS) with the RK smoother (counterpart of
adflow_tpu/solvers/multigrid.py).

Reference analogues:
- coarse-level construction by 2:1 agglomeration: ``createCoarseBlocks``
  (src/preprocessing/coarseUtils.F90);
- cycle execution: ``executeMGCycle`` + ``setCycleStrategy``
  (src/solver/multiGrid.F90:825,955), restriction ``transferToCoarseGrid``
  (:5, full weighting of the solution and residual forcing), prolongation
  ``transferToFineGrid`` (:326).

Nonlinear FAS: on each coarse level R_c(v) + f_c = 0 is smoothed with
f_c = I_h^H (R_f + f_f) - R_c(I_h^H w_f). ``ADFLOW`` builds the levels once
for its coordinates and keeps them (``ADFLOW._mg_levels``, as the
reference's ``createCoarseBlocks`` runs once in preprocessing); a cycle is
the recursion over them in Python, and the residual history is copied to
the host once per chunk of cycles, as the JAX package's ``lax.scan``
chunks are.

As in the JAX package, every level (level 0 too) is rebuilt from the mesh:
metrics by ``compute_metrics`` per block (mirrored ghost metrics at
block-to-block faces, not the solver's connected ones) and wall distances
without ``wallDistCutoff``. So a multigrid solve converges to a slightly
different state than the single-grid solve of the same case. The
prolongation is piecewise constant (the reference's is trilinear). The fine
level runs the solver's configuration, so the residual kernels launch
there; the coarse levels run the constant-coefficient coarse scheme
(``coarse_level``), which K1 takes through its coarse instantiation where
the fine scheme is the central scalar one (K2 takes no coarse level). The
smoothing of every stage is the smoothing kernel on the card
(``smoothers.residual_averaging``).

Spans (``utils/trace.py``): ``mg.cycle`` around each top-level cycle;
``mg.level.<n>`` around the work of one visit to level n, with the coarse
residual of the restricted state, level n + 1's evaluation, in a
``mg.level.<n+1>`` span of its own, so that every residual evaluation sits
under the level whose dims it runs on; ``mg.transfer`` around the
restriction of the state and the residual, the forcing's assembly, and the
prolongation with its clamped add.
"""

from __future__ import annotations

import dataclasses
import time
from typing import List, Optional, Sequence

import numpy as np
import torch

from adflow_torch.core.mesh import (B2BConnection, BCSubface, Block,
                                    MultiBlockMesh)
from adflow_torch.geom.metrics import compute_metrics
from adflow_torch.physics.residual import (
    MeshTopology, ProblemConfig, block_residual, build_topology, fill_halos)
from adflow_torch.physics.thermo import pressure
from adflow_torch.physics.timestep import local_timestep
from adflow_torch.solvers import rk_graph
from adflow_torch.solvers.smoothers import (
    RK_COEFFS, _with_interior, residual_averaging, residual_norms)
from adflow_torch.utils import trace


def coarsen_factors(dims) -> tuple:
    """Per-axis 2:1 coarsening factor: 2 where the axis is even-sized and
    > 1, else 1 (semi-coarsening for quasi-2D and odd directions; the
    reference demands fully multigrid-compatible dims, coarseUtils.F90)."""
    return tuple(2 if (d > 1 and d % 2 == 0) else 1 for d in dims)


def _coarse_rng(face, rng, f):
    """A subface's tangential cell ranges on the coarse block."""
    if rng is None:
        return None
    t1, t2 = [a for a in range(3) if a != face.axis]
    return tuple((lo // fa, (hi + fa - 1) // fa)
                 for (lo, hi), fa in zip(rng, (f[t1], f[t2])))


def coarsen_mesh(mesh: MultiBlockMesh) -> MultiBlockMesh:
    """One 2:1 (semi-)coarsening of every block (coarseUtils.F90): every
    other node, BC ranges as (lo // f, ceil(hi / f)), connection offsets
    as o // f. Host (numpy) work."""
    blocks = []
    any_coarse = False
    for b in mesh.blocks:
        f = coarsen_factors(b.dims)
        any_coarse = any_coarse or any(fa == 2 for fa in f)
        bcs = [BCSubface(sf.face, sf.bc, sf.family,
                         _coarse_rng(sf.face, sf.rng, f), sf.data)
               for sf in b.bcs]
        conns = [B2BConnection(
            face=cn.face, donor_block=cn.donor_block,
            donor_face=cn.donor_face, transform=cn.transform,
            offset=tuple(o // fa for o, fa in zip(cn.offset, f)),
            rotation=cn.rotation, translation=cn.translation,
            rng=_coarse_rng(cn.face, cn.rng, f)) for cn in b.conns]
        blocks.append(Block(name=b.name, x=b.x[::f[0], ::f[1], ::f[2]],
                            bcs=bcs, conns=conns))
    if not any_coarse:
        raise ValueError("mesh cannot be coarsened further (all block "
                         "dims odd or 1)")
    return MultiBlockMesh(blocks=blocks, name=mesh.name + "_coarse")


@dataclasses.dataclass(frozen=True)
class MGLevel:
    """The static data of one grid level, on the solver's device and in its
    dtype."""

    topo: MeshTopology
    metrics_list: tuple
    extras_list: Optional[tuple]
    vols: tuple            # interior restriction volumes per block (level 0:
                           # metric volumes; coarser: agglomerated fine sums,
                           # so restriction preserves constants exactly where
                           # coarse-node hexes differ from the fine sum)
    factors: tuple = ()    # per-block (fi, fj, fk) to the next coarser level


def build_mg_levels(mesh: MultiBlockMesh, x_list, cfg: ProblemConfig,
                    n_levels: int) -> List[MGLevel]:
    """Fine-to-coarse level hierarchy (level 0 = finest). Every level's
    topology, metrics and wall distances are made in the dtype and on the
    device of ``x_list``."""
    from adflow_torch.geom.walldist import compute_wall_distances

    dtype, device = x_list[0].dtype, x_list[0].device
    levels = []
    cur_mesh = mesh
    cur_x = list(x_list)
    prev_vols = prev_factors = None
    for lev in range(n_levels):
        topo = build_topology(cur_mesh, dtype=dtype, device=device)
        metrics = [compute_metrics(x) for x in cur_x]
        extras = None
        if cfg.rans:
            extras = tuple({"walldist": d}
                           for d in compute_wall_distances(cur_mesh, cur_x))
        if lev == 0:
            vols = tuple(m.vol[2:-2, 2:-2, 2:-2] for m in metrics)
        else:
            vols = tuple(_pool_sum(v[..., None], f)[..., 0]
                         for v, f in zip(prev_vols, prev_factors))
        factors = tuple(coarsen_factors(b.dims) for b in cur_mesh.blocks)
        levels.append(MGLevel(topo=topo, metrics_list=tuple(metrics),
                              extras_list=extras, vols=vols,
                              factors=factors))
        prev_vols, prev_factors = vols, factors
        if lev + 1 < n_levels:
            cur_mesh = coarsen_mesh(cur_mesh)
            cur_x = [torch.as_tensor(b.x, dtype=dtype, device=device)
                     for b in cur_mesh.blocks]
    return levels


# ---------------------------------------------------------------------------
# transfer operators
# ---------------------------------------------------------------------------

def _pool_sum(a, f):
    """Sum over f[0] x f[1] x f[2] cell groups (per-axis 2:1 or identity)
    of the leading three dims: (m f0, n f1, p f2, ...) -> (m, n, p, ...),
    row-major as in the JAX package."""
    m, n, p = a.shape[0] // f[0], a.shape[1] // f[1], a.shape[2] // f[2]
    return a.reshape((m, f[0], n, f[1], p, f[2]) + tuple(a.shape[3:])) \
        .sum(dim=(1, 3, 5))


def restrict_state(w_pad, vol_f, vol_c, f):
    """Volume-weighted full weighting of the interior to the coarse
    interior, returned halo-padded with zero halos (filled by the BC and
    exchange pass). transferToCoarseGrid (multiGrid.F90:5)."""
    wi = w_pad[2:-2, 2:-2, 2:-2]
    wc = _pool_sum(wi * vol_f[..., None], f) / vol_c[..., None]
    out = wc.new_zeros(tuple(d + 4 for d in wc.shape[:3]) + wc.shape[3:])
    out[2:-2, 2:-2, 2:-2] = wc
    return out


def restrict_residual(r, f):
    """Conservative restriction: the sum of the fine residuals of a
    group."""
    return _pool_sum(r, f)


def prolong_correction(cor_c, f):
    """Piecewise-constant injection of the coarse correction to the fine
    interior (the reference uses trilinear, transferToFineGrid:326;
    constant injection is the robust variant the JAX package takes, also
    for the full-multigrid start's coarse-to-fine transfer)."""
    out = cor_c
    for ax in range(3):
        if f[ax] > 1:
            out = torch.repeat_interleave(out, f[ax], dim=ax)
    return out


# ---------------------------------------------------------------------------
# forced RK smoother (the FAS forcing enters additively)
# ---------------------------------------------------------------------------

def _forced_residual(w_list, level: MGLevel, cfg, ref, f_list):
    r_list = []
    for i, (w, m) in enumerate(zip(w_list, level.metrics_list)):
        ex = level.extras_list[i] if level.extras_list else None
        r = block_residual(w, m, cfg, ref, ex, por=level.topo.blocks[i].por)
        if f_list is not None:
            r = r + f_list[i]
        r_list.append(r)
    return r_list


def _forced_rk_iteration(w_list, f_list, level: MGLevel, cfg, ref, winf,
                         cfl, coeffs, irs_eps, rsv):
    """One multistage RK iteration on one level with the FAS forcing
    ``f_list`` and the smoothing of ``irs_eps``; ``rsv``: the row scale
    (``ProblemConfig.row_scale``) or None. Returns (w_list, its first
    stage's forced residual)."""
    w0 = fill_halos(w_list, level.metrics_list, level.topo, ref, winf)
    dt_list = [local_timestep(w, pressure(w), m, cfl, cfg, ref)
               / m.vol[2:-2, 2:-2, 2:-2]
               for w, m in zip(w0, level.metrics_list)]
    wk = w0
    r_first = None
    for alpha in coeffs:
        r_list = _forced_residual(wk, level, cfg, ref, f_list)
        if r_first is None:
            r_first = r_list
        if irs_eps > 0.0:
            r_list = [residual_averaging(r, irs_eps) for r in r_list]
        if rsv is not None:
            # turbResScale rows: the explicit update needs the physical
            # residual
            r_list = [r * (1.0 / rsv) for r in r_list]
        new = [_with_interior(w0b, w0b[2:-2, 2:-2, 2:-2]
                              - alpha * dtv[..., None] * r)
               for w0b, r, dtv in zip(w0, r_list, dt_list)]
        wk = fill_halos(new, level.metrics_list, level.topo, ref, winf)
    return wk, r_first


def rk_smooth(w_list, level: MGLevel, cfg, ref, winf, cfl, f_list=None,
              n_iter: int = 1, coeffs: Sequence[float] = RK_COEFFS,
              irs_eps: float = 0.0, graphs=None, row_scale=None):
    """n_iter multistage RK iterations on one level with the FAS forcing and
    optional implicit residual smoothing. Returns (w_list, the first
    stage's forced residual).

    ``graphs``: the solve's ``rk_graph.IterationGraphs``, where the level's
    iteration is one CUDA graph from its second run in the solve on (where
    ``rk_graph.graphable`` holds; one for this call where not given): a
    solve keeps the same configuration, CFL, coefficients and smoothing on
    a level. ``row_scale``: the solve's ``cfg.row_scale``, made here where
    not given (a copy from the host)."""
    rsv = row_scale if row_scale is not None else cfg.row_scale(
        w_list[0].dtype, w_list[0].device)
    own = graphs is None
    if own:
        graphs = rk_graph.IterationGraphs()
    it = graphs.iteration(
        (id(level), cfl, irs_eps, tuple(coeffs), f_list is None),
        lambda w, f: _forced_rk_iteration(w, f, level, cfg, ref, winf, cfl,
                                          coeffs, irs_eps, rsv),
        lambda: rk_graph.graphable(w_list, level.metrics_list, level.topo,
                                   cfg, ref, winf, level.extras_list,
                                   irs_eps))
    it.force(f_list)
    r_first = None
    for _ in range(n_iter):
        w_list, r_list = it(w_list)
        if r_first is None:
            # a graph's outputs: the next replay overwrites them
            r_first = (r_list if it.graph is None
                       else [r.clone() for r in r_list])
    if own:
        graphs.close()
    return w_list, r_first


# ---------------------------------------------------------------------------
# FAS cycle
# ---------------------------------------------------------------------------

VIS2_COARSE = 0.5   # reference default vis2Coarse (doc/options.yaml)
# Coarse levels run the constant-eps2 dissipation at every RK stage, which
# tightens the dissipative stability limit of the 5-stage scheme (the
# reference instead blends dissipation between stages with rFil,
# residuals.F90:58-66); compensate with a smaller coarse CFL.
CFL_COARSE_FACTOR = 1.0 / 3.0


def _level_cfg(cfg: ProblemConfig, lev: int,
               vis2_coarse: float = VIS2_COARSE,
               coarse_disc: str = None) -> ProblemConfig:
    """Coarse levels use constant 2nd-difference dissipation (the
    reference's coarse-grid discretization, residuals.F90:70-77, options
    vis2Coarse and coarseDiscretization: an upwind fine scheme drops to the
    central scheme with constant dissipation unless coarseDiscretization
    says 'upwind'). Only the coarse levels of a central scalar fine scheme
    take the residual kernel; those of the matrix and upwind fine schemes
    stay on the plain path."""
    if lev == 0:
        return cfg
    disc = (coarse_disc or "central plus scalar dissipation").lower()
    fine = cfg.discretization
    return dataclasses.replace(
        cfg, vis2=vis2_coarse, coarse_level=True, discretization=disc,
        use_kernels=(cfg.use_kernels and fine.startswith("central")
                     and "matrix" not in fine))


def _clamped_add(w, cor, max_rel: float = 0.2):
    """Add the prolonged correction with a per-cell physicality limiter:
    scale the whole correction vector of a cell so |d rho|/rho and
    |d rhoE|/rhoE stay under max_rel (the ANK physicalityCheck idea,
    NKSolvers.F90:3013, applied to multigrid corrections). Out of place."""
    wi = w[2:-2, 2:-2, 2:-2]
    lim_rho = torch.abs(cor[..., 0]) / (max_rel * torch.abs(wi[..., 0])
                                        + 1e-30)
    lim_e = torch.abs(cor[..., 4]) / (max_rel * torch.abs(wi[..., 4])
                                      + 1e-30)
    scale = 1.0 / torch.clamp(torch.maximum(lim_rho, lim_e), min=1.0)
    return _with_interior(w, wi + scale[..., None] * cor)


def fas_cycle(w_list, levels: List[MGLevel], cfg, ref, winf, cfl,
              lev: int = 0, f_list=None, cycle: str = "v",
              n_pre: int = 1, n_post: int = 1, n_coarsest: int = 4,
              damp: float = 1.0, irs_eps: float = 0.0,
              cfl_coarse: float = None,
              vis2_coarse: float = VIS2_COARSE, coarse_disc: str = None,
              graphs=None, row_scale=None):
    """One recursive FAS V- or W-cycle starting at level ``lev``. Returns
    (w_list, the pre-smoothing's first-stage forced residual).
    ``graphs``, ``row_scale``: the solve's, for ``rk_smooth``."""
    level = levels[lev]
    cfg_l = _level_cfg(cfg, lev, vis2_coarse, coarse_disc)
    if lev == 0:
        cfl_l = cfl
    else:
        # CFLCoarse (reference inputIteration cflCoarse): the absolute
        # coarse-level CFL, with the stage-stability reduction of the
        # constant-dissipation coarse scheme
        cfl_l = (cfl if cfl_coarse is None else cfl_coarse) \
            * CFL_COARSE_FACTOR
    if lev == len(levels) - 1:
        with trace.span(f"mg.level.{lev}"):
            return rk_smooth(w_list, level, cfg_l, ref, winf, cfl_l, f_list,
                             n_iter=n_coarsest, irs_eps=irs_eps,
                             graphs=graphs, row_scale=row_scale)

    with trace.span(f"mg.level.{lev}"):
        # pre-smooth
        w_list, r_first = rk_smooth(w_list, level, cfg_l, ref, winf, cfl_l,
                                    f_list, n_iter=n_pre, irs_eps=irs_eps,
                                    graphs=graphs, row_scale=row_scale)

        # the fine forced residual at the smoothed state
        wf = fill_halos(w_list, level.metrics_list, level.topo, ref, winf)
        r_f = _forced_residual(wf, level, cfg_l, ref, f_list)

        # restrict the state and the residual
        coarse = levels[lev + 1]
        with trace.span("mg.transfer"):
            wc0 = [restrict_state(w, level.vols[i], coarse.vols[i],
                                  level.factors[i])
                   for i, w in enumerate(wf)]
            r_fc = [restrict_residual(rf, level.factors[i])
                    for i, rf in enumerate(r_f)]
        # the coarse residual of the restricted state: level lev + 1's work
        with trace.span(f"mg.level.{lev + 1}"):
            wc0f = fill_halos(wc0, coarse.metrics_list, coarse.topo, ref,
                              winf)
            r_c0 = _forced_residual(wc0f, coarse,
                                    _level_cfg(cfg, lev + 1, vis2_coarse,
                                               coarse_disc), ref, None)
        with trace.span("mg.transfer"):
            f_c = [a - b for a, b in zip(r_fc, r_c0)]

        # the coarse solve (W-cycle: two recursive visits)
        wc = wc0f
        for _ in range(2 if cycle == "w" else 1):
            wc, _ = fas_cycle(wc, levels, cfg, ref, winf, cfl, lev + 1, f_c,
                              cycle, n_pre, n_post, n_coarsest, damp,
                              irs_eps, cfl_coarse, vis2_coarse, coarse_disc,
                              graphs, row_scale)

        # prolong the correction (damped, physicality-clamped), post-smooth
        with trace.span("mg.transfer"):
            new = [_clamped_add(w, damp * prolong_correction(
                       wc[i][2:-2, 2:-2, 2:-2] - wc0[i][2:-2, 2:-2, 2:-2],
                       level.factors[i]))
                   for i, w in enumerate(w_list)]
        w_list, _ = rk_smooth(new, level, cfg_l, ref, winf, cfl_l, f_list,
                              n_iter=n_post, irs_eps=irs_eps, graphs=graphs,
                              row_scale=row_scale)
    return w_list, r_first


def parse_mg_cycle(spec: str):
    """'sg' -> (1, 'v'); '3w' -> (3, 'w'); '2v' -> (2, 'v')."""
    s = spec.strip().lower()
    if s in ("sg", "", "none", "1"):
        return 1, "v"
    return int(s[:-1]), s[-1]


def solve_mg(w_list, levels: List[MGLevel], cfg, ref, winf,
             mg_cycle: str = "3w", cfl: float = 1.5, n_cycles: int = 500,
             l2_conv: float = 1e-8, l2_conv_rel: float = 1e-16,
             monitor=None, chunk: int = 5,
             n_pre: int = 1, n_post: int = 1, cfl_coarse: float = None,
             res_averaging: str = "always", smooth_param: float = 1.5,
             deadline=None, vis2_coarse: float = VIS2_COARSE,
             coarse_disc: str = None):
    """Multigrid-cycle driver to steady state (solvers.F90 solveState, its
    multigrid branch) over ``levels`` (``build_mg_levels``'; ``mg_cycle``
    gives the cycle's type).

    n_pre/n_post: nMGFine/nMGCoarse smoothing sweeps; res_averaging and
    smooth_param: implicit residual smoothing (reference resAveraging /
    smoothParameter, inputIteration.F90), on unless 'never', with eps =
    smoothParameter - 1, so the reference default 1.5 gives the classical
    eps = 0.5. The norms stay on the device within a chunk of ``chunk``
    cycles and are copied to the host once a chunk. Each level's RK
    iteration runs as a CUDA graph from its second run on where
    ``rk_graph.graphable`` holds; the graphs live for this call.
    Returns (w_list, SolveInfo)."""
    from adflow_torch.solvers.steady import SolveInfo

    ctype = parse_mg_cycle(mg_cycle)[1]
    irs_eps = (0.0 if str(res_averaging).lower() == "never"
               else max(float(smooth_param) - 1.0, 0.0))

    graphs = rk_graph.IterationGraphs()
    # the row scale's copy to the device once a solve
    rsv = cfg.row_scale(w_list[0].dtype, w_list[0].device)
    hist_all = []
    it = 0
    r0 = None
    failed = converged = False
    while it < n_cycles:
        rows = []
        for _ in range(chunk):
            with trace.span("mg.cycle"):
                w_list, r = fas_cycle(w_list, levels, cfg, ref, winf, cfl,
                                      cycle=ctype, irs_eps=irs_eps,
                                      n_pre=n_pre, n_post=n_post,
                                      cfl_coarse=cfl_coarse,
                                      vis2_coarse=vis2_coarse,
                                      coarse_disc=coarse_disc,
                                      graphs=graphs, row_scale=rsv)
            rows.append(torch.stack(residual_norms(r)))
        hist = torch.stack(rows).double().cpu().numpy()
        trace.host_sync()
        hist_all.append(hist)
        it += hist.shape[0]
        if r0 is None:
            r0 = float(hist[0, 0])
        rnow = float(hist[-1, 0])
        if monitor:
            monitor(it, rnow, float(hist[-1, 1]))
        if not np.isfinite(rnow):
            failed = True
            break
        if rnow <= l2_conv * r0 or rnow <= l2_conv_rel:
            converged = True
            break
        if deadline is not None and time.time() >= deadline:
            break
    graphs.close()
    hist_np = np.concatenate(hist_all) if hist_all else np.zeros((0, 2))
    info = SolveInfo(
        converged=converged, failed=failed, iterations=it,
        total_r0=float(r0 if r0 else 0.0),
        total_r_final=float(hist_np[-1, 0]) if len(hist_np) else float("nan"),
        history=hist_np)
    return w_list, info
