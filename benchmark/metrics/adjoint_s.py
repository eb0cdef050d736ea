"""``adjoint_s``: the window's wall time over the adjoint solves it
completed (each unit one ``evalFunctionsSens`` of one function)."""


def read(ctx, st, records):
    return sum(r["seconds"] for r in records) / len(records)
