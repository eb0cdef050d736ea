"""``adj_pc_build_ms``: the mean of the ``adjoint.pc_build`` spans in the
profiled unit: one build of the transposed PC, once an adjoint solve.
Host clock."""

from benchmark import spans


def read(ctx, st, records):
    sp = spans.profiled(ctx)
    return sp and spans.mean_ms(spans.named(sp, "adjoint.pc_build"))
