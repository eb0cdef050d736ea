"""``ank_pc_apply_span_ms``: the median of the ``krylov.precond`` spans
under ``newton.step`` in the profiled unit: one apply of the lagged line PC
as GMRES calls it (the last of a restart cycle also forms the update).
Host clock."""

from benchmark import spans


def read(ctx, st, records):
    sp = spans.profiled(ctx)
    return sp and spans.median_ms(
        spans.under(sp, "krylov.precond", "newton.step"))
