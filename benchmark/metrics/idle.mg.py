"""The device's idle share over the profiled unit, in percent: 1 - (the
union of the device operations' intervals) / (the unit's wall from a
synchronised start to a synchronised end)."""


def read(ctx, st, records):
    return None if ctx.profile is None else ctx.profile["idle_pct"]
