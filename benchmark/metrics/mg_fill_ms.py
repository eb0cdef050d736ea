"""``mg_fill_ms``: the halo fills' time a W-cycle in the profiled unit: the
``halo.fill`` spans under ``mg.cycle`` (every level's fills, each a BC
pass, the exchange and a BC pass), summed, over the ``mg.cycle`` spans.
Host clock."""

from benchmark import mg_spans


def read(ctx, st, records):
    return mg_spans.per_cycle_ms(ctx, "halo.fill")
