"""``k2_roofline``: K2's share of its roofline in the profiled unit: the
least time of one launch at the cell's block dims (``roofline/k2.py``)
over the profiler's device time a launch of ``inviscid_residual_kernel``,
in percent."""

from benchmark import roofline


def read(ctx, st, records):
    return roofline.share(ctx, "k2", "inviscid_residual_kernel")
