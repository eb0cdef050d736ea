"""``adj_gmres_self_ms``: GMRES's own time an iteration in the adjoint
solves of the profiled unit, as ``ank_gmres_self_ms`` under
``adjoint.solve``. Host clock."""

from benchmark import spans


def read(ctx, st, records):
    sp = spans.profiled(ctx)
    return sp and spans.gmres_self_ms(sp, "adjoint.solve")
