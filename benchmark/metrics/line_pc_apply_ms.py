"""``line_pc_apply_ms``: one apply of the ANK step's three-axis line PC,
built at the window's last state and CFL, timed alone as
``jvp_matvec_ms`` is."""

from benchmark import harness, program


def read(ctx, st, records):
    if not ctx.cuda:
        return None
    _, precond, v = program.newton_pieces(st)
    return harness.time_ms(lambda: precond(v), reps=20, warmup=1)
