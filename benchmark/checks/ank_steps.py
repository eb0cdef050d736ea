"""Check ``ank_steps``: what the window's ANK solves produced, against the
plain reference in float64.

Every unit: the residual norm the program reports at its final state, and
cl and cd there. The steps of one unit drawn from the seed (the last unit
where the window held fewer): at each step's state before and after, the
residual norms the step reports, and the linear residual of the step's
Newton system, ||(V/dt + J) dx + R|| / ||R|| for the direction dx the
program took, against the one its GMRES reports.

Each step's stats vector and CFL come from what the program publishes
after a solve, ``SolveInfo.steps`` (one ``StepRecord`` a step). The states
a step starts from and ends at are not published, so they are kept by
wrapping ``make_ank_step`` of the program's Newton driver: the wrapper
takes any arguments, keeps a reference to the state the step is handed
and the ``w`` of what it returns (no copy, no synchronisation), and passes
everything else through. A unit whose kept states do not match its
``StepRecord``s one to one reads NaN, so a program that no longer makes
its steps there fails the check rather than passing it unchecked. The
reference follows the program step by step from the program's own states
here, since an ANK solve's Krylov path in float32 is not the one float64
takes; the start of the first step is the benchmark's own seeded state.

Numbers compared (each the largest over what is checked):
``res_rel``: |reported norm - reference norm| / reference norm;
``linres_gap``: |reported linear residual - reference's|;
``cl_gap``, ``cd_gap``: |program's - reference's|.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from benchmark import judge

SAMPLE_FROM = 3   # the unit checked step by step is one of the first three
# positions in a StepRecord's stats vector (solvers/newton.py's driver
# unpacks it so)
R_BEFORE, R_AFTER, ALPHA, LINRES = 0, 1, 2, 5


def install(ctx):
    from adflow_torch.solvers import newton

    ctx.ank_states = []
    ctx.ank_sample = judge.sample(ctx.seed, SAMPLE_FROM)
    ctx.ank_orig = orig = newton.make_ank_step

    def make_ank_step(*args, **kw):
        step = orig(*args, **kw)

        def ank_step(wvec, *a, **k):
            res = step(wvec, *a, **k)
            ctx.ank_states.append((wvec, res.w))
            return res
        return ank_step

    newton.make_ank_step = make_ank_step


def begin(ctx):
    ctx.ank_states, ctx.ank_kept, ctx.ank_n = [], {}, 0


def after_unit(ctx, st, rec):
    """Keep the step states of the sampled unit and of the latest one."""
    states, ctx.ank_states = ctx.ank_states, []
    ctx.ank_kept = {k: v for k, v in ctx.ank_kept.items()
                    if k == ctx.ank_sample}
    ctx.ank_kept[ctx.ank_n] = states
    ctx.ank_n += 1


def collect(ctx, st, records):
    from adflow_torch.solvers import newton
    newton.make_ank_step = ctx.ank_orig
    n = len(records)
    k = ctx.ank_sample if ctx.ank_sample < n else n - 1
    states = ctx.ank_kept.get(k, [])
    recs = [r for r in records[k]["info"].steps if r.kind == "ANK"]
    if len(states) != len(recs) or not recs:
        print(f"benchmark: unit {k} kept {len(states)} step states for "
              f"{len(recs)} ANK steps", file=sys.stderr)
        steps = None
    else:
        steps = [(w0, float(r.cfl), w1, np.asarray(r.stats, dtype=float))
                 for (w0, w1), r in zip(states, recs)]
    finals = [(judge.interior(r["w_list"]), r["info"].total_r_final,
               r["funcs"]) for r in records]
    return {"spec": st.spec, "name": st.ap.name, "steps": steps,
            "finals": finals}


def _readings(ref, judged, ref64=None):
    """The numbers compared, of the program's outputs in ``judged``
    against ``ref``; with ``ref64``, of ``ref`` in the program's place
    against ``ref64`` at the same states (the control)."""
    name = judged["name"]
    res, lin, cl, cd = [], [], [], []
    if judged["steps"] is None:      # the steps' states were not kept
        res.append(float("nan"))
        lin.append(float("nan"))
    for w0, cfl, w1, stats in judged["steps"] or ():
        if ref64 is None:
            got = (stats[R_BEFORE], stats[R_AFTER], stats[LINRES])
            want = (ref.norms(w0)[0], ref.norms(w1)[0],
                    ref.ank_linear_residual(w0, w1, stats[ALPHA], cfl))
        else:
            got = (ref.norms(w0)[0], ref.norms(w1)[0],
                   ref.ank_linear_residual(w0, w1, stats[ALPHA], cfl))
            want = (ref64.norms(w0)[0], ref64.norms(w1)[0],
                    ref64.ank_linear_residual(w0, w1, stats[ALPHA], cfl))
        res += [judge.rel_gap(got[0], want[0]), judge.rel_gap(got[1], want[1])]
        lin.append(abs(got[2] - want[2]))
    for w, r_final, funcs in judged["finals"]:
        if ref64 is None:
            f = ref.functions(w)
            got_r, want_r = r_final, ref.norms(w)[0]
            got_f, want_f = (funcs[f"{name}_cl"], funcs[f"{name}_cd"]), (
                f["cl"], f["cd"])
        else:
            f, f64 = ref.functions(w), ref64.functions(w)
            got_r, want_r = ref.norms(w)[0], ref64.norms(w)[0]
            got_f, want_f = (f["cl"], f["cd"]), (f64["cl"], f64["cd"])
        res.append(judge.rel_gap(got_r, want_r))
        cl.append(abs(got_f[0] - want_f[0]))
        cd.append(abs(got_f[1] - want_f[1]))
    return {"res_rel": judge.worst(res), "linres_gap": judge.worst(lin),
            "cl_gap": judge.worst(cl), "cd_gap": judge.worst(cd)}


def compare(ctx, judged):
    ref = judge.reference(ctx, judged["spec"])
    got = _readings(ref, judged)
    limits = ctx.cell.traffic["check"]["limits"]
    return [(k, got[k], float(limits[k])) for k in limits]


def control(ctx, judged, dtype=torch.bfloat16):
    """The control's readings: the reference in ``dtype`` put in the
    program's place, at the program's states."""
    ref64 = judge.reference(ctx, judged["spec"])
    low = judge.reference(ctx, judged["spec"], dtype=dtype)
    return _readings(low, judged, ref64=ref64)
