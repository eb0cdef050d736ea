"""``ank_pc_build_ms``: the mean of the ``newton.pc_build`` spans in the
profiled unit: one build of the Newton driver's lagged PC (the line PC's
blocks at the step's state and CFL), made only when the lag runs out.
Host clock."""

from benchmark import spans


def read(ctx, st, records):
    sp = spans.profiled(ctx)
    return sp and spans.mean_ms(spans.named(sp, "newton.pc_build"))
