"""``vjp_matvec_ms``: one matvec of the adjoint's transposed operator
(the vjp of the residual, built once as the adjoint solve builds it),
timed alone at the set-up's state (CUDA events, median of 20 after
warm-up)."""

from benchmark import harness, program


def read(ctx, st, records):
    if not ctx.cuda:
        return None
    vjp, _, v = program.adjoint_pieces(st, ctx.seed)
    return harness.time_ms(lambda: vjp(v), reps=20, warmup=1)
