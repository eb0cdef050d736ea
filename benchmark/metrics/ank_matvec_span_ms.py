"""``ank_matvec_span_ms``: the median of the ``krylov.matvec`` spans under
``newton.step`` in the profiled unit: one matvec of the ANK step's linear
operator (V/dt v + J v, J v by ``torch.func.jvp`` of the residual) as the
solve loop runs it, or a restart's b - A x. Host clock."""

from benchmark import spans


def read(ctx, st, records):
    sp = spans.profiled(ctx)
    return sp and spans.median_ms(
        spans.under(sp, "krylov.matvec", "newton.step"))
