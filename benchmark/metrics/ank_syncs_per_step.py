"""``ank_syncs_per_step``: the program's ``host_syncs`` counter (each
device-to-host copy of the solve loops) inside the ``newton.step`` spans
of the profiled unit, over the steps."""

from benchmark import spans


def read(ctx, st, records):
    sp = spans.profiled(ctx)
    return sp and spans.per_span(sp, "newton.step", "host_syncs")
