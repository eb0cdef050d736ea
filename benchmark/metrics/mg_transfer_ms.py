"""``mg_transfer_ms``: the transfers between levels a W-cycle in the
profiled unit: the ``mg.transfer`` spans (the restriction of the state and
of the residual, the forcing's assembly, the prolongation and its clamped
add), over the ``mg.cycle`` spans. Host clock."""

from benchmark import mg_spans


def read(ctx, st, records):
    out = mg_spans.split(ctx)
    if out is None:
        return None
    cycles, _, transfer = out
    return 1e3 * transfer / cycles
