"""``tpc_apply_ms``: one apply of the adjoint's transposed line PC, built
as the adjoint solve builds it, timed alone as ``vjp_matvec_ms`` is."""

from benchmark import harness, program


def read(ctx, st, records):
    if not ctx.cuda:
        return None
    _, precond, v = program.adjoint_pieces(st, ctx.seed)
    return harness.time_ms(lambda: precond(v), reps=20, warmup=1)
