"""Gloo process groups for the port's several-device tests, and the work
each rank does. Imports no JAX: every rank is a spawned process that
imports this module by name.

``World(n, target, tmp_path, *args)`` spawns ``n`` ranks, each with
one thread, joined by ``init_method=file://`` under ``tmp_path`` (a fixed
TCP port would collide between the test workers), runs
``target(group, *args)`` on each, a function of this module; its
``result()`` is rank 0's (``run_world`` does both). A rank that raises
fails the run with its traceback; a world that does not finish within
``timeout`` seconds is killed.

The cases (``stacked_case``, ``sharded_case``) and the results
(``stacked_results``, ``sharded_results``) are shared by the ranks and by
the tests' world-size-1 references, which run them with ``group=None``.
"""

import multiprocessing
import os
import pickle
import tempfile
import time
import traceback

import numpy as np
import torch

STACKED_DIMS = (32, 12, 8)
TIMEOUT = 300


def _rank_main(rank, n, init_file, out_dir, target, args):
    torch.set_num_threads(1)
    import torch.distributed as dist

    err = os.path.join(out_dir, f"error_{rank}.txt")
    try:
        dist.init_process_group("gloo", init_method=f"file://{init_file}",
                                rank=rank, world_size=n)
        try:
            res = globals()[target](dist.group.WORLD, *args)
            if rank == 0:
                with open(os.path.join(out_dir, "result.pkl"), "wb") as f:
                    pickle.dump(res, f)
        finally:
            dist.destroy_process_group()
    except BaseException:
        with open(err, "w") as f:
            f.write(traceback.format_exc())
        raise


class World:
    """``n`` gloo ranks running ``target(group, *args)``, started at
    construction, so the caller can work meanwhile; ``result()`` waits for
    them and returns rank 0's result."""

    def __init__(self, n, target, tmp_path, *args, timeout=TIMEOUT):
        self.n, self.target, self.timeout = n, target, timeout
        self.out_dir = tempfile.mkdtemp(prefix=f"world_{target}_{n}_",
                                        dir=str(tmp_path))
        ctx = multiprocessing.get_context("spawn")
        self.procs = [ctx.Process(
            target=_rank_main,
            args=(r, n, os.path.join(self.out_dir, "init"), self.out_dir,
                  target, args)) for r in range(n)]
        self.t0 = time.monotonic()
        for p in self.procs:
            p.start()

    def result(self):
        try:
            for p in self.procs:
                p.join(max(1.0, self.t0 + self.timeout - time.monotonic()))
        finally:
            for p in self.procs:
                if p.is_alive():
                    p.kill()
                    p.join()
        errors = [open(os.path.join(self.out_dir, f)).read()
                  for f in sorted(os.listdir(self.out_dir))
                  if f.startswith("error_")]
        name = f"{self.target} on {self.n} ranks"
        if errors:
            raise RuntimeError(f"{name} failed:\n{errors[0]}")
        codes = [p.exitcode for p in self.procs]
        if any(c != 0 for c in codes):
            raise RuntimeError(f"{name}: exit codes {codes} (killed after "
                               f"{self.timeout} s?)")
        with open(os.path.join(self.out_dir, "result.pkl"), "rb") as f:
            return pickle.load(f)


def run_world(n, target, tmp_path, *args, timeout=TIMEOUT):
    """Rank 0's result of ``target(group, *args)`` on ``n`` gloo ranks."""
    return World(n, target, tmp_path, *args, timeout=timeout).result()


# ---------------------------------------------------------------------------
# the stacked layout
# ---------------------------------------------------------------------------

def stacked_case(case, n_balance=4, group=None):
    """A stacked case as this rank's stacked problem: 'euler' or 'rans',
    the 32x12x8 wing balanced over ``n_balance`` slots (the JAX package's
    tests/test_stacked.py case), or 'dummy', the 6-cell Euler cube cut at
    i = 2 and balanced over 2 (blocks of 2x6x6 and 4x3x6 in a 4x6x6
    bucket, and a dummy fourth slot). A namespace of mesh, prob, cfg, ref,
    winf (tensor), sm and extras."""
    import types

    from adflow_torch.core.refstate import AeroProblem, make_reference_state
    from adflow_torch.dist import stacked
    from adflow_torch.geom.walldist import compute_wall_distances
    from adflow_torch.meshgen.analytic import cube_mesh, wing_omesh
    from adflow_torch.physics.residual import ProblemConfig

    equation_type = "euler" if case == "dummy" else case
    viscous = equation_type != "euler"
    cfg = ProblemConfig(
        equation_type=equation_type, vis2=0.25, vis4=1.0 / 64.0,
        diss_exponent=0.67, turbulence_model="sa",
        turb_res_scale=(1e4 if equation_type == "rans" else 1.0))
    if case == "dummy":
        mesh2, order = stacked.balance_blocks(
            stacked.split_block(cube_mesh(n=6), 0, 0, 2), 2)
        ap = AeroProblem(name="c", mach=0.4, alpha=1.0)
    else:
        mesh2, order = stacked.balance_blocks(
            wing_omesh(*STACKED_DIMS, viscous=viscous), n_balance)
        ap = AeroProblem(name="w", mach=0.6, alpha=2.0,
                         reynolds=(1e6 if viscous else None))
    ref = make_reference_state(ap, lift_index=2, n_turb=cfg.n_turb)
    winf = torch.as_tensor(ref.winf())
    prob = stacked.build_stacked_problem(mesh2, order, group=group)
    sm = stacked.stack_metrics(mesh2, prob, torch.float64)
    extras = None
    if cfg.rans:
        xs = [torch.as_tensor(b.x) for b in mesh2.blocks]
        extras = {"walldist": stacked.stack_walldist(
            mesh2, prob, compute_wall_distances(mesh2, xs), torch.float64)}
    return types.SimpleNamespace(mesh=mesh2, prob=prob, cfg=cfg, ref=ref,
                                 winf=winf, sm=sm, extras=extras)


def seeded_stack(c, seed=0, amp=1e-3):
    """Every slot of the case's stack (the whole stack, ranks' slices
    taken by ``mine``) at a seeded perturbation of the free stream."""
    from adflow_torch.dist import stacked

    full = stacked.build_stacked_problem(c.mesh, c.prob.order)
    w = stacked.stack_state(full, c.winf, torch.float64).numpy()
    rng = np.random.default_rng(seed)
    return torch.as_tensor(w * (1.0 + amp * rng.standard_normal(w.shape)))


def mine(c, full):
    """This rank's slots of a whole-stack tensor."""
    return full[c.prob.slots[0]:c.prob.slots[-1] + 1].clone()


def _gather(c, t):
    from adflow_torch.dist import comm
    return comm.gather_stack(t, c.prob.group).numpy()


def stacked_results(group, case, rk_steps=2, ank=True):
    """The stacked checks on this rank's slots, gathered: the exchange of
    a seeded field, its jvp and the dot-product identity of its backward,
    the residual, ``rk_steps`` RK steps and one ANK step (at CFL 5, from
    the RK steps' state), and a GMRES solve over the group."""
    from adflow_torch.dist import comm, stacked
    from adflow_torch.solvers.krylov import gmres

    c = stacked_case(case, group=group)
    prob = c.prob
    w_all = seeded_stack(c)
    w = mine(c, w_all)
    out = {}
    ex = comm.exchange(w, prob.plan)
    out["exchange"] = _gather(c, ex)
    t_all = seeded_stack(c, seed=1, amp=1.0) - w_all
    u_all = seeded_stack(c, seed=2, amp=1.0) - w_all
    t, u = mine(c, t_all), mine(c, u_all)
    _, jt = torch.func.jvp(lambda v: comm.exchange(v, prob.plan), (w,), (t,))
    out["exchange_jvp"] = _gather(c, jt)
    _, vjp = torch.func.vjp(lambda v: comm.exchange(v, prob.plan), w)
    (et_u,) = vjp(u)
    out["dot_forward"] = float(comm.all_sum(torch.sum(jt * u), group))
    out["dot_backward"] = float(comm.all_sum(torch.sum(t * et_u), group))
    r = stacked.stacked_residual(w, c.sm, prob, c.cfg, c.ref, c.winf,
                                 c.extras)
    out["residual"] = _gather(c, r)
    step = stacked.make_stacked_rk_step(prob, c.cfg, c.ref, cfl=1.0)
    wk = stacked.stack_state(prob, c.winf, torch.float64)
    for _ in range(rk_steps):
        wk, norms = step(wk, c.sm, c.winf, c.extras)
    out["rk"] = _gather(c, wk)
    out["rk_norms"] = norms.numpy()
    if ank:
        w2, r0, r1, lin = stacked.stacked_ank_step(
            wk, c.sm, prob, c.cfg, c.ref, c.winf, 5.0, extras=c.extras)
        out["ank"] = _gather(c, w2)
        out["ank_stats"] = np.array([r0, r1, lin])

    # GMRES over the group on a seeded diagonally dominant operator that
    # couples the cells of each slot (so it is the same for every split)
    n = w[0, ..., :5].numel()
    rng = np.random.default_rng(3)
    d_all = torch.as_tensor(2.0 + rng.random(prob.nb * n))
    b_all = torch.as_tensor(rng.standard_normal(prob.nb * n))
    lo, hi = prob.slots[0] * n, (prob.slots[-1] + 1) * n
    d, b = d_all[lo:hi], b_all[lo:hi]
    per = len(prob.slots)
    sol = gmres(lambda v: d * v + 0.1 * torch.roll(v.reshape(per, n), 1,
                                                   1).reshape(-1), b, m=15,
                restarts=2, tol=1e-12, group=group)
    out["gmres"] = comm.gather_stack(sol.x, group).numpy()
    out["gmres_iters"] = sol.iters
    return out


# ---------------------------------------------------------------------------
# the k-split
# ---------------------------------------------------------------------------

def sharded_case(equation_type, group=None):
    """The 32x12x8 wing k-split over the group's ranks (the JAX package's
    tests/test_sharded.py case): a namespace of prob, cfg, ref, winf and
    this rank's w, metrics and wall distance."""
    import types

    from adflow_torch.core.refstate import AeroProblem, make_reference_state
    from adflow_torch.dist import comm, sharded
    from adflow_torch.geom.metrics import compute_metrics
    from adflow_torch.geom.walldist import compute_wall_distances
    from adflow_torch.meshgen.analytic import wing_omesh
    from adflow_torch.physics.residual import ProblemConfig

    viscous = equation_type != "euler"
    mesh = wing_omesh(*STACKED_DIMS, viscous=viscous)
    cfg = ProblemConfig(equation_type=equation_type, vis2=0.25,
                        vis4=1.0 / 64.0, diss_exponent=0.67,
                        turbulence_model="sa")
    ap = AeroProblem(name="w", mach=0.6, alpha=2.0,
                     reynolds=(1e6 if viscous else None))
    ref = make_reference_state(ap, lift_index=2, n_turb=cfg.n_turb)
    winf = torch.as_tensor(ref.winf())
    x = torch.as_tensor(mesh.blocks[0].x)
    d = compute_wall_distances(mesh, [x])[0] if cfg.rans else None
    rank, n = comm.world(group)
    prob = sharded.build_sharded_problem(mesh, n, group=group)
    w_st, d_st = sharded.shard_arrays(mesh, prob, winf, torch.float64, d)
    m_st = sharded.split_metrics(compute_metrics(x), n)
    return types.SimpleNamespace(
        prob=prob, cfg=cfg, ref=ref, winf=winf, w=w_st[rank],
        w_seeded=torch.as_tensor(seeded_shards(ref.winf(), mesh, n)[rank]),
        metrics=sharded.shard_of(m_st, rank),
        d=None if d_st is None else d_st[rank])


def seeded_shards(winf, mesh, n, seed=0, amp=1e-3):
    """(n, ni+4, nj+4, nkl+4, nw): the padded global block at a seeded
    perturbation of the free stream, cut into ``n`` k-shards. An ANK step
    from the exact free stream sits on the JST sensor's kink, where the
    rounding of the ghost states picks the derivative."""
    ni, nj, nk = mesh.blocks[0].dims
    winf = np.asarray(winf, np.float64)
    w = np.broadcast_to(winf, (ni + 4, nj + 4, nk + 4, len(winf)))
    rng = np.random.default_rng(seed)
    w = w * (1.0 + amp * rng.standard_normal(w.shape))
    nkl = nk // n
    return np.stack([w[:, :, s * nkl:(s + 1) * nkl + 4] for s in range(n)])


def _gather_k(t, group):
    """The global k-interior (ni, nj, nk, nv) from each rank's shard."""
    from adflow_torch.dist import comm
    rank, n = comm.world(group)
    inner = t[2:-2, 2:-2, 2:-2].contiguous()
    if group is None:
        return inner.numpy()
    import torch.distributed as dist
    parts = [torch.empty_like(inner) for _ in range(n)]
    dist.all_gather(parts, inner, group=group)
    return torch.cat(parts, dim=2).numpy()


def sharded_results(group, equation_type, n_iters=3, ank=True):
    """The k-split checks, gathered: ``n_iters`` RK iterations (CFL 1)
    with their norms from the free stream, one ANK step (CFL 5) with the
    adjoint matvec's norm from ``seeded_shards``, and
    ``k_ring_results``."""
    from adflow_torch.dist import sharded, sharded_newton

    c = sharded_case(equation_type, group)
    step = sharded.make_sharded_step(c.prob, c.cfg, c.ref, n_iters=n_iters,
                                     cfl=1.0)
    w, hist = step(c.w, c.metrics, c.winf, c.d)
    out = {"rk": _gather_k(w, group), "rk_hist": hist.numpy()}
    if ank:
        adj = sharded_newton.make_sharded_ank_adjoint_step(c.prob, c.cfg,
                                                           c.ref, cfl=5.0)
        w2, stats = adj(c.w_seeded, c.metrics, c.winf, c.d)
        out["ank"] = _gather_k(w2, group)
        out["ank_stats"] = stats
    if group is not None:
        out["ring"] = k_ring_results(group)
    return out


def k_ring_results(group, seed=0):
    """``exchange_k_halos`` of a seeded (6, 5, 6, 3) field per rank, and
    its jvp and the dot-product identity of its backward: the gathered
    exchanged fields, the seeded fields (n, 6, 5, 6, 3), and the forward
    and backward dots."""
    import torch.distributed as dist

    from adflow_torch.dist import comm, sharded

    rank, n = comm.world(group)
    rng = np.random.default_rng(seed)
    w_all, t_all, u_all = (torch.as_tensor(rng.standard_normal(
        (n, 6, 5, 6, 3))) for _ in range(3))
    w, t, u = w_all[rank], t_all[rank], u_all[rank]

    def f(v):
        return sharded.exchange_k_halos(v, group)

    out, jt = torch.func.jvp(f, (w,), (t,))
    _, vjp = torch.func.vjp(f, w)
    (et_u,) = vjp(u)
    parts = [torch.empty_like(out) for _ in range(n)]
    dist.all_gather(parts, out.contiguous(), group=group)
    return {"out": torch.stack(parts).numpy(), "w": w_all.numpy(),
            "dot_forward": float(comm.all_sum(torch.sum(jt * u), group)),
            "dot_backward": float(comm.all_sum(torch.sum(t * et_u),
                                               group))}


# ---------------------------------------------------------------------------
# the API
# ---------------------------------------------------------------------------

API_BASE = {"equationType": "euler", "useANKSolver": True,
            "useNKSolver": False, "nCycles": 220, "L2Convergence": 1e-6,
            "printIterations": False, "printTiming": False}


def api_results(group, mesh_name, mesh_kw, ap_kw, options):
    """``ADFLOW(meshDevices=<group size>)`` through ``__call__`` and
    ``evalFunctions`` on each rank: its converged flag, iterations, cl
    (where asked), whether every block's state is finite, and the block
    count after balancing."""
    from adflow_torch.api.solver import ADFLOW
    from adflow_torch.core.refstate import AeroProblem
    from adflow_torch.dist import comm
    from adflow_torch.meshgen import analytic

    n = comm.world(group)[1]
    s = ADFLOW(options=dict(API_BASE, meshDevices=n, **options),
               mesh=getattr(analytic, mesh_name)(**mesh_kw), comm=group,
               device="cpu")
    ap = AeroProblem(**ap_kw)
    s(ap)
    funcs = {}
    if ap_kw.get("evalFuncs"):
        s.evalFunctions(ap, funcs)
    return {"converged": s.solve_info.converged,
            "iterations": s.solve_info.iterations,
            "funcs": funcs, "n_blocks": len(s.mesh.blocks),
            "finite": all(bool(torch.isfinite(w).all()) for w in s.w_list)}


def api_refusals(group):
    """The several-device refusals on the group: ``haloExchangeMode``
    'ppermute' at the solve, and ``meshDevices`` other than the group's
    size at construction; (exception type name, message) of each."""
    from adflow_torch.api.solver import ADFLOW
    from adflow_torch.core.refstate import AeroProblem
    from adflow_torch.dist import comm
    from adflow_torch.meshgen.analytic import cube_mesh

    n = comm.world(group)[1]
    out = {}
    s = ADFLOW(options=dict(API_BASE, meshDevices=n,
                            haloExchangeMode="ppermute"),
               mesh=cube_mesh(n=6), comm=group, device="cpu")
    try:
        s(AeroProblem(name="pp", mach=0.4, alpha=0.0))
        out["ppermute"] = None
    except NotImplementedError as e:
        out["ppermute"] = (type(e).__name__, str(e))
    try:
        ADFLOW(options=dict(API_BASE, meshDevices=2 * n),
               mesh=cube_mesh(n=6), comm=group, device="cpu")
        out["size"] = None
    except ValueError as e:
        out["size"] = (type(e).__name__, str(e))
    return out
