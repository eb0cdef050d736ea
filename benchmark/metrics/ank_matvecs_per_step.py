"""``ank_matvecs_per_step``: the mean of the GMRES matvecs of the window's
ANK steps (``StepRecord.krylov_matvecs``: one a restart cycle and one an
iteration)."""


def read(ctx, st, records):
    steps = [s for r in records for s in r["info"].steps]
    return sum(s.krylov_matvecs for s in steps) / len(steps) if steps \
        else None
