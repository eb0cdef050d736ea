"""``rk_cycle_ms``: the window's wall time over all the RK cycles its
solves ran (each unit: setStates, the configuration's cycles,
evalFunctions)."""


def read(ctx, st, records):
    cycles = sum(r["info"].iterations for r in records)
    return 1e3 * sum(r["seconds"] for r in records) / cycles
