"""Check ``adjoint_totals``: the window's adjoints against the plain
reference in float64, at the state the set-up's solve left.

For one unit of each function drawn from the seed: the program's adjoint
psi and what it reports of it. The reference works out, at the same
state, the relative residual of the transposed system ||dR/dw^T psi -
dI/dw|| / ||dI/dw|| for that psi, and the totals dI/d* = dI/d*|direct -
psi^T dR/d* of alpha, mach and the node coordinates assembled with it.
Every unit of one function starts from zero at the same state, so every
one repeats the sampled one's work (the driver checks their iterations and
launches).

Numbers compared (each the largest over the functions):
``adj_res_gap``: |reported relative residual - reference's|;
``total_rel``: |program's total - reference's| / |reference's|, of alpha
and mach; ``xv_rel``: the largest difference of the coordinate totals over
the reference's largest entry.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark import judge


def install(ctx):
    pass


def begin(ctx):
    ctx.adj_seen = {}


def after_unit(ctx, st, rec):
    """Keep the unit of each function that the seed draws from its first
    two, or the latest where the window held fewer."""
    key = rec["key"]
    n = ctx.adj_seen.get(key, 0)
    ctx.adj_seen[key] = n + 1
    rec["kept"] = n <= judge.sample(ctx.seed, 2,
                                            salt=sum(map(ord, key)))


def collect(ctx, st, records):
    chosen = {}
    for rec in records:
        if rec["kept"]:
            chosen[rec["key"]] = rec
    return {"spec": st.spec, "state": st.solver.getStates(),
            "units": [(k, r["psi"], r["rel"],
                       {"alpha": r["sens"]["alpha"],
                        "mach": r["sens"]["mach"],
                        "xv": np.asarray(r["sens"]["xv"], dtype=np.float64)})
                      for k, r in chosen.items()]}


def _measure(units, assemble):
    res, tot_rel, xv = [], [], []
    for key, psi, rel, tot in units:
        rel_ref, tot_ref = assemble(key, psi)
        xv_ref = tot_ref["xv"].cpu().numpy()
        res.append(abs(rel - rel_ref))
        tot_rel += [judge.rel_gap(tot[k], tot_ref[k]) for k in ("alpha", "mach")]
        xv.append(np.abs(tot["xv"] - xv_ref).max() / np.abs(xv_ref).max())
    return {"adj_res_gap": judge.worst(res), "total_rel": judge.worst(tot_rel),
            "xv_rel": judge.worst(xv)}


def compare(ctx, judged):
    ref = judge.reference(ctx, judged["spec"])
    got = _measure(judged["units"], lambda key, psi: ref.adjoint_check(
        judged["state"], psi, key))
    limits = ctx.cell.traffic["check"]["limits"]
    return [(k, got[k], float(limits[k])) for k in limits]


def control(ctx, judged, dtype=torch.bfloat16):
    """The control's readings: the reference in ``dtype`` assembling the
    same adjoints in the program's place, against the float64 one."""
    ref64 = judge.reference(ctx, judged["spec"])
    low = judge.reference(ctx, judged["spec"], dtype=dtype)
    units = []
    for key, psi, _, _ in judged["units"]:
        rel, tot = low.adjoint_check(judged["state"], psi, key)
        tot = dict(tot, xv=tot["xv"].cpu().numpy())
        units.append((key, psi, rel, tot))
    return _measure(units, lambda key, psi: ref64.adjoint_check(
        judged["state"], psi, key))
