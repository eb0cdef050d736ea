"""``k1_mg_roofline``: K1's share of its roofline over the multigrid levels
in the profiled unit: the sum over the levels of K1's launches under the
level's spans (``mg_spans.split``) times the least time of one launch at
the level's dims (``roofline/k1.py``), over the profiler's device time of
``rans_residual_kernel`` in the unit, in percent."""

from benchmark import mg_spans, roofline


def read(ctx, st, records):
    out = mg_spans.split(ctx)
    t = mg_spans.device_seconds(ctx, "rans_residual_kernel")
    if out is None or not t:
        return None
    least = sum(v[1] * roofline.least_seconds(
        "k1", mg_spans.level_dims(ctx, lev)) for lev, v in out[1].items())
    return 100.0 * least / t if least else None
