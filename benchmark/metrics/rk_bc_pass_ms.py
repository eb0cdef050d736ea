"""``rk_bc_pass_ms``: the median of the ``halo.bc_pass`` spans under
``smoother.cycle`` in the profiled unit: one pass of a block's physical
BCs over its ghost layers (``physics/bc.py`` ``apply_bcs``). Host clock."""

from benchmark import spans


def read(ctx, st, records):
    sp = spans.profiled(ctx)
    return sp and spans.median_ms(
        spans.under(sp, "halo.bc_pass", "smoother.cycle"))
