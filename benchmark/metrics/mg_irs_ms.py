"""``mg_irs_ms``: the median of the ``smoother.irs`` spans in the profiled
unit: one implicit residual smoothing of a block's stage residual along
its three axes (``solvers/smoothers.py`` ``residual_averaging``). Host
clock."""

from benchmark import mg_spans


def read(ctx, st, records):
    return mg_spans.smoothing_median_ms(ctx)
