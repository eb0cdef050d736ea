"""``mg_bc_pass_ms``: the physical-BC passes' time a W-cycle in the profiled
unit: the ``halo.bc_pass`` spans under ``mg.cycle`` (every level's passes,
two a halo fill, ``physics/bc.py`` ``apply_bcs``), summed, over the
``mg.cycle`` spans. Host clock."""

from benchmark import mg_spans


def read(ctx, st, records):
    return mg_spans.per_cycle_ms(ctx, "halo.bc_pass")
