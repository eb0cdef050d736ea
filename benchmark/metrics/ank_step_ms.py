"""``ank_step_ms``: the Newton driver's own wall time per ANK step
(``StepRecord.seconds``, from fetching the PC to the step's stats on the
host), over the steps of the window's solves that were not profiled."""


def read(ctx, st, records):
    steps = [s for r in records if not r["profiled"]
             for s in r["info"].steps]
    return 1e3 * sum(s.seconds for s in steps) / len(steps) if steps else None
