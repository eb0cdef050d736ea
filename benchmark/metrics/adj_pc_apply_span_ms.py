"""``adj_pc_apply_span_ms``: the median of the ``krylov.precond`` spans
under ``adjoint.solve`` in the profiled unit: one apply of the transposed
line PC as the adjoint's GMRES calls it. Host clock."""

from benchmark import spans


def read(ctx, st, records):
    sp = spans.profiled(ctx)
    return sp and spans.median_ms(
        spans.under(sp, "krylov.precond", "adjoint.solve"))
