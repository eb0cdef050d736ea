"""``irs_roofline``: the residual-smoothing kernel's share of its roofline
in the profiled unit: the sum over the multigrid levels of its launches
under the level's spans (the ``irs_launches`` counter, ``mg_spans.split``)
times the least time of one launch at the level's dims
(``roofline/irs.py``), over the profiler's device time of
``irs_line_kernel`` in the unit, in percent."""

from benchmark import mg_spans, roofline


def read(ctx, st, records):
    out = mg_spans.split(ctx)
    t = mg_spans.device_seconds(ctx, "irs_line_kernel")
    if out is None or not t:
        return None
    nv = mg_spans.n_channels(ctx)
    least = sum(v[2] * roofline.least_seconds(
        "irs", mg_spans.level_dims(ctx, lev) + (nv,))
        for lev, v in out[1].items())
    return 100.0 * least / t if least else None
