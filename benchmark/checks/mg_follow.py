"""Check ``mg_follow``: what the window's multigrid solves produced, against
the plain reference in float64 (``reference/multigrid.py``) that follows
the same cycles from the same seeded start.

The reference runs the configuration's ``nCycles`` FAS cycles from the
benchmark's own seeded start once (every unit of the window starts from
it). Each unit is compared with it as ``rk_follow`` compares an RK solve:
the mean-flow and the SA residual norms the program reported at every
cycle (the fine level's first-stage residual, through K1, at the states
the window produced) against the reference's at its own cycle, the unit's
final state against the reference's, group by group, and the unit's cl and
cd against the reference's functions at the unit's own final state.

Numbers compared (each the largest over the units and cycles), as in
``rk_follow``: ``hist_rel``, ``turb_rel``: |reported norm - reference
norm| / reference norm; ``state_mf``, ``state_sa``: ||w - w_ref||_2 /
||w_ref - w_start||_2 of the mean-flow channels and of the SA channel;
``cl_gap``, ``cd_gap``: |program's - reference's|.

The control (the reference in a lower precision in the program's place) is
read at the float64 reference's states: its norms at the reference's state
of each cycle, its final state as its one last cycle from the reference's
state before it.
"""

from __future__ import annotations

import numpy as np

from benchmark import harness, judge, program
from benchmark.reference.multigrid import Multigrid

_rk = harness.check_module("rk_follow")


def install(ctx):
    pass


def begin(ctx):
    pass


def after_unit(ctx, st, rec):
    pass


def collect(ctx, st, records):
    return _rk.collect(ctx, st, records)


def _multigrid(ctx, ref) -> Multigrid:
    return Multigrid(ref, program.options(ctx.cell.config))


def compare(ctx, judged):
    ref = judge.reference(ctx, judged["spec"])
    judged["followed"] = states, hist_ref = _multigrid(ctx, ref).cycles(
        judged["start"], judged["n_cycles"])
    got = _rk._measure(judged["units"], hist_ref, states[-1], states[0],
                       ref.nw, ref.functions)
    limits = ctx.cell.traffic["check"]["limits"]
    return [(k, got[k], float(limits[k])) for k in limits]


def control(ctx, judged, dtype):
    """The control's readings: the reference in ``dtype`` put in the
    program's place at the same states: its norms at the float64
    reference's state of each cycle, its final state its one last cycle
    from the reference's state before it, its functions at that state."""
    ref64 = judge.reference(ctx, judged["spec"])
    low = judge.reference(ctx, judged["spec"], dtype=dtype)
    mg_low = _multigrid(ctx, low)
    states, hist_ref = judged["followed"]
    h_low = np.array([mg_low.norms(w) for w in states[:-1]])
    w_low = mg_low.cycles(states[-2], 1)[0][-1]
    f = low.functions(w_low)
    return _rk._measure([(w_low, h_low, (f["cl"], f["cd"]))], hist_ref,
                        states[-1], states[0], ref64.nw, ref64.functions)
