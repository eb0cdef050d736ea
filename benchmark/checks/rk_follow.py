"""Check ``rk_follow``: what the window's RK solves produced, against the
plain reference in float64 that follows the same cycles from the same
seeded start.

The reference runs the configuration's ``nCycles`` RK cycles from the
benchmark's own seeded start once (every unit of the window starts from
it). Each unit is compared with it: the mean-flow and the turbulence
residual norms the program reported at every cycle (the residual through
K1 at the states the window produced) against the reference's at its own
cycle, the unit's final state against the reference's, group by group,
and the unit's cl and cd against the reference's functions at the unit's
own final state.

Numbers compared (each the largest over the units and cycles):
``hist_rel``, ``turb_rel``: |reported norm - reference norm| / reference
norm, of the mean flow and of the SA channel;
``state_mf``, ``state_sa``: ||w - w_ref||_2 / ||w_ref - w_start||_2 over
the cells, of the mean-flow channels and of the SA channel: the gap of
the final state as a share of the change the cycles made;
``cl_gap``, ``cd_gap``: |program's - reference's|.

The control (the reference in a lower precision in the program's place)
is read at the float64 reference's states, as a served model's is at the
same tokens: its norms at the reference's state of each cycle, its final
state as its one last cycle from the reference's state before it. Its own
50 cycles in bfloat16 from the start turn to NaN on the full wing, which
fails every limit but sets none.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark import judge

N_MEAN = 5     # the mean-flow channels; the rest are the SA channel


def install(ctx):
    pass


def begin(ctx):
    pass


def after_unit(ctx, st, rec):
    pass


def collect(ctx, st, records):
    name = st.ap.name
    return {"spec": st.spec, "start": st.start64,
            "n_cycles": int(ctx.cell.config["nCycles"]),
            "cfl": float(ctx.cell.config["CFL"]),
            "units": [(judge.interior(r["w_list"]),
                       np.asarray(r["info"].history)[:, :2],
                       (r["funcs"][f"{name}_cl"], r["funcs"][f"{name}_cd"]))
                      for r in records]}


def follow(ref, judged):
    """The reference's cycles from the seeded start: the flat state at the
    start of each cycle and after the last, and each cycle's first-stage
    (mean-flow, turbulence) norms."""
    w = ref.as_vec(judged["start"])
    states, hist = [], []
    for _ in range(judged["n_cycles"]):
        states.append(w)
        w, h = ref.rk_cycles(w, 1, judged["cfl"])
        hist.append(h[0])
    states.append(w)
    return states, np.array(hist)


def _state_gaps(w, want, start, nw):
    """(mean flow, SA) of ||w - want|| / ||want - start|| by channel
    group, in float64."""
    d = (w.double().reshape(-1, nw) - want.double().reshape(-1, nw))
    c = (want.double().reshape(-1, nw) - start.double().reshape(-1, nw))
    return [float(torch.linalg.norm(d[:, sl])
                  / torch.linalg.norm(c[:, sl]).clamp_min(1e-300))
            if d[:, sl].numel() else 0.0
            for sl in (slice(0, N_MEAN), slice(N_MEAN, nw))]


def _hist_gap(h, want):
    if len(h) != len(want):
        return float("inf")
    return float(np.max(np.abs(h - want)
                        / np.maximum(np.abs(want), 1e-300)))


def _measure(units, hist_ref, w_ref, w_start, nw, functions):
    """The numbers compared of ``units`` [(final state, reported norms
    (cycles, 2), (cl, cd))] against the reference's norms, final state and
    ``functions``."""
    hist, turb, smf, ssa, cl, cd = [], [], [], [], [], []
    for w, h, (cl_u, cd_u) in units:
        hist.append(_hist_gap(h[:, 0], hist_ref[:, 0]))
        turb.append(_hist_gap(h[:, 1], hist_ref[:, 1]))
        g = _state_gaps(w.to(w_ref.device), w_ref, w_start, nw)
        smf.append(g[0])
        ssa.append(g[1])
        f = functions(w)
        cl.append(abs(cl_u - f["cl"]))
        cd.append(abs(cd_u - f["cd"]))
    return {"hist_rel": judge.worst(hist), "turb_rel": judge.worst(turb),
            "state_mf": judge.worst(smf), "state_sa": judge.worst(ssa),
            "cl_gap": judge.worst(cl), "cd_gap": judge.worst(cd)}


def compare(ctx, judged):
    ref = judge.reference(ctx, judged["spec"])
    judged["followed"] = states, hist_ref = follow(ref, judged)
    got = _measure(judged["units"], hist_ref, states[-1], states[0], ref.nw,
                   ref.functions)
    limits = ctx.cell.traffic["check"]["limits"]
    return [(k, got[k], float(limits[k])) for k in limits]


def control(ctx, judged, dtype=torch.bfloat16):
    """The control's readings: the reference in ``dtype`` put in the
    program's place at the same states: its norms at the float64
    reference's state of each cycle, its final state its one last cycle
    from the reference's state before it, its functions at that state."""
    ref64 = judge.reference(ctx, judged["spec"])
    low = judge.reference(ctx, judged["spec"], dtype=dtype)
    states, hist_ref = judged["followed"]
    h_low = np.array([low.norms(w)[1:] for w in states[:-1]])
    w_low = low.rk_cycles(states[-2], 1, judged["cfl"])[0]
    f = low.functions(w_low)
    return _measure([(w_low, h_low, (f["cl"], f["cd"]))], hist_ref,
                    states[-1], states[0], ref64.nw, ref64.functions)
