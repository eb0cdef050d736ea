"""Traffic kind ``solve``: repeated steady solves of one aero problem, each
from the same seeded start, as an optimizer asks for a design point and
waits for it (closed loop, one at a time). A unit is ``setStates(start)``,
``solver(ap)`` (the configuration's ``nCycles``) and
``evalFunctions(ap)``."""

from __future__ import annotations

import math

import numpy as np

from benchmark import program


def setup(ctx):
    st = program.build(ctx)
    for _ in range(int(ctx.cell.traffic["warmup_units"])):
        unit(ctx, st, -1)
    return st


def unit(ctx, st, i):
    s = st.solver
    n0 = program.launches(st.counter)
    s.setStates(st.start)
    s(st.ap)
    funcs = s.evalFunctions(st.ap, {})
    return {"info": s.solve_info, "funcs": funcs, "w_list": s.w_list,
            "launches": program.launches(st.counter) - n0}


def describe(rec) -> str:
    info = rec["info"]
    txt = (f"{info.iterations} iterations, R {info.history[0, 0]:.6e} -> "
           f"{info.total_r_final:.6e}, {rec['launches']} launches")
    if info.steps:
        txt += (f"; Krylov iterations "
                f"{[int(s.stats[4]) for s in info.steps]}, first R "
                f"{info.steps[0].stats[0]:.6e}")
    return txt


def expected_launches(rule: str, info) -> int:
    """Residual-kernel launches a solve makes: the Newton driver's two
    starting norms and its steps' exact evaluations (``newton``), or one a
    stage of every RK cycle (``rk``)."""
    if rule == "newton":
        return 2 + sum(r.res_evals for r in info.steps)
    if rule == "rk":
        return 5 * info.iterations
    raise ValueError(f"launch rule {rule!r}")


def failed_units(ctx, st, records) -> int:
    """Units that failed or did other work than the first: a failed or
    non-finite solve, another number of steps or cycles, launches other
    than the rule's, or functions that are not finite."""
    rule = ctx.cell.traffic["launches"]["rule"]
    first = records[0]["info"]
    shape = (first.iterations, len(first.steps))
    bad = 0
    for rec in records:
        info = rec["info"]
        ok = (not info.failed and np.all(np.isfinite(info.history))
              and (info.iterations, len(info.steps)) == shape
              and all(math.isfinite(v) for v in rec["funcs"].values()))
        if ctx.expect_launches:
            ok = ok and rec["launches"] == expected_launches(rule, info)
        bad += not ok
    return bad
