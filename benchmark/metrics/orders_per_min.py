"""``orders_per_min``: orders of magnitude of the mean-flow residual that
the window's solves took off, over the minutes they took: the sum over
the units of log10(R_start / R_end), R_start the norm the Newton driver
reports at the seeded start (its first step's) and R_end the solve's
final one, divided by the units' wall time in minutes. A step made cheaper
but less effective gains nothing here."""

import math


def read(ctx, st, records):
    orders = sum(math.log10(r["info"].steps[0].stats[0]
                            / r["info"].total_r_final) for r in records)
    minutes = sum(r["seconds"] for r in records) / 60.0
    return orders / minutes
