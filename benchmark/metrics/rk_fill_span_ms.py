"""``rk_fill_span_ms``: the median of the ``halo.fill`` spans under
``smoother.cycle`` in the profiled unit: one halo fill (BC pass, exchange,
BC pass) as the RK stages run it. Host clock."""

from benchmark import spans


def read(ctx, st, records):
    sp = spans.profiled(ctx)
    return sp and spans.median_ms(
        spans.under(sp, "halo.fill", "smoother.cycle"))
