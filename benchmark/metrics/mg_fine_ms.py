"""``mg_fine_ms``: the fine level's own work a W-cycle in the profiled unit:
the ``mg.level.0`` spans less the coarser levels' spans and the transfers
inside them (its smoothing sweeps, its forced residual, its fills), over
the ``mg.cycle`` spans. Host clock."""

from benchmark import mg_spans


def read(ctx, st, records):
    out = mg_spans.split(ctx)
    if out is None or 0 not in out[1]:
        return None
    cycles, levels, _ = out
    return 1e3 * levels[0][0] / cycles
