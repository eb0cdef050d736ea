"""``k1_roofline``: K1's share of its roofline in the profiled unit: the
least time of one launch at the cell's block dims (``roofline/k1.py``)
over the profiler's device time a launch of ``rans_residual_kernel``, in
percent."""

from benchmark import roofline


def read(ctx, st, records):
    return roofline.share(ctx, "k1", "rans_residual_kernel")
