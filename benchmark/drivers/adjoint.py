"""Traffic kind ``adjoint``: repeated adjoint solves at one state, as an
optimizer asks for the gradient of each function at a design point
(closed loop, one at a time). Set-up solves from the seeded start (the
configuration's ``nCycles``); a unit is ``evalFunctionsSens`` of one
function, the traffic's functions in turn, each adjoint from zero."""

from __future__ import annotations

import math

import numpy as np

from benchmark import program


def setup(ctx):
    st = program.build(ctx)
    s = st.solver
    s.setStates(st.start)
    s(st.ap)
    st.solve_info = s.solve_info
    for _ in range(int(ctx.cell.traffic["warmup_units"])):
        unit(ctx, st, -1)
    return st


def function_of(ctx, i: int) -> str:
    funcs = ctx.cell.traffic["funcs"]
    return funcs[max(i, 0) % len(funcs)]


def unit(ctx, st, i):
    s = st.solver
    key = function_of(ctx, i)
    n0 = program.launches(st.counter)
    sens = s.evalFunctionsSens(st.ap, {}, [key])[f"{st.ap.name}_{key}"]
    info = s.adjoint_info
    return {"key": key, "sens": sens, "psi": info.x,
            "rel": info.res_norm / max(info.b_norm, 1e-300),
            "iters": info.iters,
            "launches": program.launches(st.counter) - n0}


def describe(rec) -> str:
    return (f"{rec['key']}: {rec['iters']} GMRES iterations to rel "
            f"{rec['rel']:.6e}, {rec['launches']} launches")


def failed_units(ctx, st, records) -> int:
    """Units that failed or did other work: another number of GMRES
    iterations than ``adjointMaxIter``, launches other than the
    traffic's, or totals that are not finite."""
    iters = int(ctx.cell.config["adjointMaxIter"])
    per_call = int(ctx.cell.traffic["launches"]["per_unit"])
    bad = 0
    for rec in records:
        sens = rec["sens"]
        ok = (rec["iters"] == iters and math.isfinite(rec["rel"])
              and all(math.isfinite(sens[k]) for k in ("alpha", "mach"))
              and bool(np.all(np.isfinite(sens["xv"]))))
        if ctx.expect_launches:
            ok = ok and rec["launches"] == per_call
        bad += not ok
    return bad
