"""``mg_coarse_ms``: the coarse levels' own work a W-cycle in the profiled
unit: the own part of every ``mg.level.<n>`` span with n >= 1 (its
smoothing sweeps, its residuals, its fills; the transfers left out), over
the ``mg.cycle`` spans. Host clock."""

from benchmark import mg_spans


def read(ctx, st, records):
    out = mg_spans.split(ctx)
    if out is None:
        return None
    cycles, levels, _ = out
    coarse = [v[0] for lev, v in levels.items() if lev >= 1]
    return 1e3 * sum(coarse) / cycles if coarse else None
