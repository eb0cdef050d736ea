"""Traffic kind ``mg``: the ``solve`` driver's units (``setStates(start)``,
``solver(ap)``, ``evalFunctions(ap)``, closed loop) for a configuration
whose solve is FAS multigrid (``MGCycle`` other than 'sg'), with the launch
rule of a multigrid cycle: one residual-kernel launch for every residual
evaluation on every level, worked out from the options."""

from __future__ import annotations

import inspect
import math

import numpy as np

from benchmark import harness

_solve = harness.driver_module("solve")

setup = _solve.setup
unit = _solve.unit
describe = _solve.describe

RK_STAGES = 5      # the program's RK5 smoother: one evaluation a stage


def n_coarsest() -> int:
    """RK iterations a visit to the coarsest level: the default of the
    program's ``multigrid.fas_cycle``, which its solve does not set."""
    from adflow_torch.solvers import multigrid
    return inspect.signature(
        multigrid.fas_cycle).parameters["n_coarsest"].default


def evaluations_by_level(options: dict, coarsest_iterations: int,
                         rk_stages_only: bool = False) -> list:
    """Residual evaluations of one cycle of ``options['MGCycle']`` on each
    level, finest first. A visit to a level above the coarsest: the
    pre-smoothing's stages (nMGFine RK iterations), the forced residual at
    the smoothed state, the coarse residual of the restricted state (a
    level below), the visits to the next level (two for 'w', one for 'v')
    and the post-smoothing's stages (nMGCoarse iterations); a visit to the
    coarsest: ``coarsest_iterations`` RK iterations. With
    ``rk_stages_only`` the RK stages alone (each smooths its residual)."""
    spec = str(options["MGCycle"]).strip().lower()
    n_levels, kind = int(spec[:-1]), spec[-1]
    visits = 2 if kind == "w" else 1
    pre, post = int(options["nMGFine"]), int(options["nMGCoarse"])
    counts = [0] * n_levels

    def visit(lev, times):
        if lev == n_levels - 1:
            counts[lev] += times * RK_STAGES * coarsest_iterations
            return
        extra = 0 if rk_stages_only else 1
        counts[lev] += times * (RK_STAGES * (pre + post) + extra)
        counts[lev + 1] += times * extra  # the restricted state's residual
        visit(lev + 1, times * visits)

    visit(0, 1)
    return counts


def launches_per_cycle(ctx) -> int:
    return sum(evaluations_by_level(ctx.cell.config, n_coarsest()))


def failed_units(ctx, st, records) -> int:
    """Units that failed or did other work than the first: a failed or
    non-finite solve, another number of cycles, residual-kernel launches
    other than the rule's (``launches_per_cycle`` a cycle), or functions
    that are not finite."""
    if ctx.cell.traffic["launches"]["rule"] != "mg":
        raise ValueError(f"launch rule {ctx.cell.traffic['launches']!r}")
    per_cycle = launches_per_cycle(ctx)
    first = records[0]["info"]
    bad = 0
    for rec in records:
        info = rec["info"]
        ok = (not info.failed and np.all(np.isfinite(info.history))
              and info.iterations == first.iterations
              and all(math.isfinite(v) for v in rec["funcs"].values()))
        if ctx.expect_launches:
            ok = ok and rec["launches"] == per_cycle * info.iterations
        bad += not ok
    return bad
