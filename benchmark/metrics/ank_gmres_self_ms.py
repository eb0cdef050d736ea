"""``ank_gmres_self_ms``: GMRES's own time an iteration in the ANK steps
of the profiled unit: over the ``krylov.gmres`` spans under
``newton.step``, their time less their ``krylov.matvec`` and
``krylov.precond`` spans (the Gram-Schmidt products, the column's copy to
the host, the Givens rotations, the update), over their ``krylov.iter``
spans. Host clock."""

from benchmark import spans


def read(ctx, st, records):
    sp = spans.profiled(ctx)
    return sp and spans.gmres_self_ms(sp, "newton.step")
