"""FAS multigrid with the five-stage RK smoother, in plain PyTorch: the
reference that a multigrid cell's cycles are held to, on the benchmark's
own ``Reference`` of the configuration (its coordinates, conditions and
free stream). Written for the benchmark from the semantics of ADflow's
``executeMGCycle`` (src/solver/multiGrid.F90:825) as the program runs it;
it shares only the plain residual pieces of this package (the JST, viscous
and SA residuals, the BCs, the halo exchange, the metrics, the wall
distance and the time step), which it calls.

What it holds:

- the levels: 2:1 coarsening of every axis that is even and longer than 1
  (every other node; a BC or connection range (lo // f, ceil(hi / f));
  connection offsets o // f), each level's metrics per block (mirrored
  ghost metrics at block-to-block faces) and wall distance, worked out in
  float64 from the coordinates and rounded to the reference's dtype, and
  the restriction volumes: level 0's cell volumes, each coarser level's the
  sums of its finer level's over the cell's group (so a constant restricts
  exactly);
- the transfers: the volume-weighted restriction of the state, the
  conservative restriction of the residual (the group's sum), and
  piecewise-constant prolongation of the coarse correction added with the
  physicality clamp (a cell's whole correction scaled so that |d rho| / rho
  and |d rhoE| / rhoE stay under 0.2);
- the smoother: RK5 (0.25, 1/6, 0.375, 0.5, 1) with the local time step
  frozen over the stages, the FAS forcing added to every stage's residual,
  implicit residual smoothing (I - eps d^2)^-1 along each axis of at least
  3 cells with eps = smoothParameter - 1 (here by the dense inverse of the
  line's matrix, end rows 1 + eps), and the turbulence rows' scale taken
  back out before the update; no point-implicit SA diagonal;
- the coarse levels' scheme: the JST residual with constant dissipation
  (``fluxes.inviscid_residual(const_diss=True)``, vis2Coarse), the viscous
  and SA residuals as on the fine level, CFLCoarse times 1/3;
- the cycle: pre-smoothing (nMGFine), the forced residual, the restricted
  state and forcing, two visits to the next level for 'w' (one for 'v'),
  the clamped prolonged correction, post-smoothing (nMGCoarse); 4 RK
  iterations on the coarsest level.

Departures from ADflow, as in the program: piecewise-constant injection in
place of trilinear prolongation; the constant coarse dissipation at every
RK stage in place of the ``rFil`` blend of the stages' dissipation, and the
coarse CFL factor 1/3 that makes up for it; the physicality clamp on the
prolonged correction; level 0 rebuilt with per-block metrics, so its
ghost metrics at the O-mesh's wrap cut are mirrored, not connected.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import torch

from .fluxes import inviscid_residual
from .mesh import B2BConnection, BCSubface, Block, MultiBlockMesh
from .metrics import BlockMetrics, compute_metrics
from .residual import block_residual, build_topology, fill_halos
from .thermo import pressure
from .timestep import local_timestep

RK_COEFFS = (0.25, 1.0 / 6.0, 0.375, 0.5, 1.0)
CFL_COARSE_FACTOR = 1.0 / 3.0
N_COARSEST = 4          # RK iterations on the coarsest level
MAX_REL = 0.2           # the physicality clamp of the prolonged correction
N_MEAN = 5


def coarsen_factors(dims) -> tuple:
    return tuple(2 if (d > 1 and d % 2 == 0) else 1 for d in dims)


def _coarse_rng(face, rng, f):
    if rng is None:
        return None
    t1, t2 = [a for a in range(3) if a != face.axis]
    return tuple((lo // fa, (hi + fa - 1) // fa)
                 for (lo, hi), fa in zip(rng, (f[t1], f[t2])))


def coarsen_mesh(mesh: MultiBlockMesh) -> MultiBlockMesh:
    blocks = []
    for b in mesh.blocks:
        f = coarsen_factors(b.dims)
        bcs = [BCSubface(sf.face, sf.bc, sf.family,
                         _coarse_rng(sf.face, sf.rng, f), sf.data)
               for sf in b.bcs]
        conns = [B2BConnection(
            face=c.face, donor_block=c.donor_block, donor_face=c.donor_face,
            transform=c.transform,
            offset=tuple(o // fa for o, fa in zip(c.offset, f)),
            rotation=c.rotation, translation=c.translation,
            rng=_coarse_rng(c.face, c.rng, f)) for c in b.conns]
        blocks.append(Block(name=b.name, x=b.x[::f[0], ::f[1], ::f[2]],
                            bcs=bcs, conns=conns))
    return MultiBlockMesh(blocks=blocks, name=mesh.name + "_coarse")


def pool_sum(a, f):
    """Sum over the f0 x f1 x f2 groups of the leading three dims."""
    m, n, p = a.shape[0] // f[0], a.shape[1] // f[1], a.shape[2] // f[2]
    return a.reshape((m, f[0], n, f[1], p, f[2]) + tuple(a.shape[3:])) \
        .sum(dim=(1, 3, 5))


def prolong(c, f):
    """Piecewise-constant injection to the finer level's cells."""
    for ax in range(3):
        if f[ax] > 1:
            c = torch.repeat_interleave(c, f[ax], dim=ax)
    return c


@dataclasses.dataclass
class Level:
    topo: object
    metrics_list: list
    extras_list: Optional[list]
    vols: list
    factors: list


def _cast(m: BlockMetrics, dtype) -> BlockMetrics:
    return BlockMetrics(*(None if t is None else t.to(dtype) for t in m))


def smooth_axis(r, axis: int, eps: float):
    """(I - eps d^2)^-1 r along ``axis``, the line's end rows 1 + eps: the
    line's matrix inverted in float64 and applied in r's dtype."""
    n = r.shape[axis]
    a = torch.diag(torch.full((n,), 1.0 + 2.0 * eps, dtype=torch.float64))
    a -= eps * (torch.diag(torch.ones(n - 1, dtype=torch.float64), 1)
                + torch.diag(torch.ones(n - 1, dtype=torch.float64), -1))
    a[0, 0] = a[-1, -1] = 1.0 + eps
    inv = torch.linalg.inv(a).to(dtype=r.dtype, device=r.device)
    return torch.movedim(torch.tensordot(inv, torch.movedim(r, axis, 0),
                                         dims=1), 0, axis)


def residual_smoothing(r, eps: float):
    for axis in range(3):
        if r.shape[axis] >= 3:
            r = smooth_axis(r, axis, eps)
    return r


class Multigrid:
    """The FAS cycles of one configuration on the mesh of ``reference`` (a
    ``benchmark.reference.Reference``), in its dtype and on its device;
    ``options``: the configuration's solver options."""

    def __init__(self, reference, options: dict):
        self.r = reference
        self.n_levels = int(str(options["MGCycle"]).strip()[:-1])
        self.cycle = str(options["MGCycle"]).strip()[-1].lower()
        self.n_pre = int(options.get("nMGFine", 1))
        self.n_post = int(options.get("nMGCoarse", 1))
        self.cfl = float(options["CFL"])
        self.cfl_coarse = float(options.get("CFLCoarse", 1.0))
        self.vis2_coarse = float(options.get("vis2Coarse", 0.5))
        disc = str(options.get("coarseDiscretization",
                               "central plus scalar dissipation")).lower()
        if disc != "central plus scalar dissipation":
            raise NotImplementedError(f"coarse discretization {disc!r}")
        self.eps = (0.0 if str(options.get("resAveraging", "alternate"))
                    .lower() == "never"
                    else max(float(options.get("smoothParameter", 1.5))
                             - 1.0, 0.0))
        cfg = reference.cfg
        self.cfgs = [cfg] + [dataclasses.replace(cfg, vis2=self.vis2_coarse)
                             ] * (self.n_levels - 1)
        self.levels = self._build()

    def _build(self) -> List[Level]:
        from .walldist import compute_wall_distances
        r = self.r
        f64 = dict(dtype=torch.float64, device=r.device)
        mesh, x_list = r.mesh, r.x_list
        levels, prev = [], None
        for lev in range(self.n_levels):
            if lev:
                mesh = coarsen_mesh(mesh)
                x_list = [torch.as_tensor(b.x, **f64) for b in mesh.blocks]
            metrics = [compute_metrics(x) for x in x_list]
            extras = None
            if r.cfg.rans:
                # the reference's own fine wall distance (its cutoff 1e20
                # cuts nothing) on level 0
                d_list = ([e["walldist"] for e in r.extras_list] if lev == 0
                          else [d.to(r.dtype) for d in
                                compute_wall_distances(mesh, x_list)])
                extras = [{"walldist": d} for d in d_list]
            factors = [coarsen_factors(b.dims) for b in mesh.blocks]
            if lev == 0:
                vols = [m.vol[2:-2, 2:-2, 2:-2] for m in metrics]
            else:
                vols = [pool_sum(v[..., None], f)[..., 0]
                        for v, f in zip(prev.vols, prev.factors)]
            levels.append(Level(
                topo=build_topology(mesh, dtype=r.dtype, device=r.device),
                metrics_list=[_cast(m, r.dtype) for m in metrics],
                extras_list=extras, vols=vols, factors=factors))
            prev = levels[-1]
        for lv in levels:
            lv.vols = [v.to(r.dtype) for v in lv.vols]
        return levels

    # -- the pieces -----------------------------------------------------------
    def residual(self, w_list, lev: int, f_list=None):
        """The residual of every block of level ``lev`` at halo-filled
        states, plus the forcing ``f_list``."""
        level, cfg = self.levels[lev], self.cfgs[lev]
        out = []
        for i, (w, m) in enumerate(zip(w_list, level.metrics_list)):
            ex = level.extras_list[i] if level.extras_list else None
            por = level.topo.blocks[i].por
            if lev == 0:
                r = block_residual(w, m, cfg, self.r.ref, ex, por=por)
            else:
                r = self._coarse_residual(w, m, cfg, ex, por)
            out.append(r if f_list is None else r + f_list[i])
        return out

    def _coarse_residual(self, w, m, cfg, extras, por):
        p = pressure(w)
        r = inviscid_residual(w, p, m, cfg.vis2, cfg.vis4, cfg.diss_exponent,
                              por=por, const_diss=True)
        if cfg.viscous:
            from .viscous import viscous_residual
            r = r + viscous_residual(w, p, m, cfg, self.r.ref, extras=extras)
        if cfg.rans:
            from .sa import sa_residual
            rt = sa_residual(w, p, m, cfg, self.r.ref,
                             extras["walldist"] if extras else None)
            r = torch.cat([r, rt], dim=-1)
        return r

    def fill(self, w_list, lev: int):
        level = self.levels[lev]
        return fill_halos(w_list, level.metrics_list, level.topo, self.r.ref,
                          self.r.winf)

    def rk(self, w_list, lev: int, f_list, n_iter: int):
        """``n_iter`` forced RK5 iterations on level ``lev``: (w_list, the
        first stage's forced residual)."""
        level, cfg = self.levels[lev], self.cfgs[lev]
        cfl = self.cfl if lev == 0 else self.cfl_coarse * CFL_COARSE_FACTOR
        scale = torch.tensor((1.0,) * N_MEAN + cfg.turb_scales,
                             dtype=self.r.dtype, device=self.r.device)
        r_first = None
        for _ in range(n_iter):
            w0 = self.fill(w_list, lev)
            dt = [local_timestep(w, pressure(w), m, cfl, cfg, self.r.ref)
                  / m.vol[2:-2, 2:-2, 2:-2]
                  for w, m in zip(w0, level.metrics_list)]
            wk = w0
            for alpha in RK_COEFFS:
                r_list = self.residual(wk, lev, f_list)
                if r_first is None:
                    r_first = r_list
                new = []
                for wb, r, d in zip(w0, r_list, dt):
                    if self.eps > 0.0:
                        r = residual_smoothing(r, self.eps)
                    r = r / scale
                    out = wb.clone()
                    out[2:-2, 2:-2, 2:-2] = (wb[2:-2, 2:-2, 2:-2]
                                             - alpha * d[..., None] * r)
                    new.append(out)
                wk = self.fill(new, lev)
            w_list = wk
        return w_list, r_first

    def fas(self, w_list, lev: int = 0, f_list=None):
        """One cycle from level ``lev``: (w_list, the pre-smoothing's first
        forced residual)."""
        if lev == self.n_levels - 1:
            return self.rk(w_list, lev, f_list, N_COARSEST)
        level, coarse = self.levels[lev], self.levels[lev + 1]
        w_list, r_first = self.rk(w_list, lev, f_list, self.n_pre)
        wf = self.fill(w_list, lev)
        r_f = self.residual(wf, lev, f_list)
        wc0 = []
        for i, w in enumerate(wf):
            wc = pool_sum(w[2:-2, 2:-2, 2:-2] * level.vols[i][..., None],
                          level.factors[i]) / coarse.vols[i][..., None]
            pad = wc.new_zeros(tuple(d + 4 for d in wc.shape[:3])
                               + wc.shape[3:])
            pad[2:-2, 2:-2, 2:-2] = wc
            wc0.append(pad)
        wc0f = self.fill(wc0, lev + 1)
        r_c0 = self.residual(wc0f, lev + 1)
        f_c = [pool_sum(a, level.factors[i]) - b
               for i, (a, b) in enumerate(zip(r_f, r_c0))]
        wc = wc0f
        for _ in range(2 if self.cycle == "w" else 1):
            wc, _ = self.fas(wc, lev + 1, f_c)
        new = []
        for i, w in enumerate(w_list):
            cor = prolong(wc[i][2:-2, 2:-2, 2:-2] - wc0[i][2:-2, 2:-2, 2:-2],
                          level.factors[i])
            wi = w[2:-2, 2:-2, 2:-2]
            lim = torch.maximum(
                torch.abs(cor[..., 0]) / (MAX_REL * torch.abs(wi[..., 0])
                                          + 1e-30),
                torch.abs(cor[..., 4]) / (MAX_REL * torch.abs(wi[..., 4])
                                          + 1e-30))
            out = w.clone()
            out[2:-2, 2:-2, 2:-2] = wi + (1.0 / torch.clamp(lim, min=1.0)
                                          )[..., None] * cor
            new.append(out)
        w_list, _ = self.rk(new, lev, f_list, self.n_post)
        return w_list, r_first

    # -- what the solver reports ---------------------------------------------
    @staticmethod
    def _norms(r_list):
        r = torch.cat([a.reshape(-1, a.shape[-1]) for a in r_list]).double()
        return torch.stack((torch.linalg.norm(r[:, :N_MEAN]),
                            torch.linalg.norm(r[:, N_MEAN:])))

    def norms(self, vec):
        """(mean-flow, turbulence) norms of the fine residual at ``vec``:
        what a cycle from ``vec`` reports."""
        w = self.fill(self.r.padded(self.r.as_vec(vec)), 0)
        return self._norms(self.residual(w, 0)).cpu().numpy()

    def cycles(self, vec, n_cycles: int):
        """``n_cycles`` cycles from the flat state ``vec``: the flat state
        at the start of each cycle and after the last, and each cycle's
        reported (mean-flow, turbulence) norms, (n_cycles, 2)."""
        w_list = self.r.padded(self.r.as_vec(vec))
        states, hist = [], []
        for _ in range(n_cycles):
            states.append(self.r.pack([w[2:-2, 2:-2, 2:-2] for w in w_list]))
            w_list, r = self.fas(w_list)
            hist.append(self._norms(r))
        states.append(self.r.pack([w[2:-2, 2:-2, 2:-2] for w in w_list]))
        return states, torch.stack(hist).cpu().numpy()
