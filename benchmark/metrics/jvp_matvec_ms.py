"""``jvp_matvec_ms``: one matvec of the ANK step's linear operator, V/dt v
+ J v with J v by ``torch.func.jvp`` of the residual, timed alone at the
window's last state and CFL (CUDA events, median of 20 after warm-up:
a host-bound chain, so the host's pace)."""

from benchmark import harness, program


def read(ctx, st, records):
    if not ctx.cuda:
        return None
    matvec, _, v = program.newton_pieces(st)
    return harness.time_ms(lambda: matvec(v), reps=20, warmup=1)
