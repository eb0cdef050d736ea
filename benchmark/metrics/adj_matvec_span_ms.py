"""``adj_matvec_span_ms``: the median of the ``krylov.matvec`` spans under
``adjoint.solve`` in the profiled unit: one vjp of the residual (the
transposed operator) as the adjoint's GMRES calls it. Host clock."""

from benchmark import spans


def read(ctx, st, records):
    sp = spans.profiled(ctx)
    return sp and spans.median_ms(
        spans.under(sp, "krylov.matvec", "adjoint.solve"))
