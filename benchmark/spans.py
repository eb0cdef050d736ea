"""What the in-loop per-layer readers share: the spans the program's tracer
(``adflow_torch.utils.trace``) recorded in the profiled unit, and the
selections the readers make of them. Where there are none (the CPU, where
no unit is profiled, or a program without the tracer) ``profiled`` gives
None, and so does every reader."""

from __future__ import annotations

import statistics


def profiled(ctx):
    """The spans of the profiled unit, or None."""
    if ctx.profile is None:
        return None
    try:
        from adflow_torch.utils import trace
    except ImportError:
        return None
    return trace.spans() or None


def _above(by_id, s, name: str):
    """The nearest span above ``s`` named ``name``, or None."""
    p = by_id.get(s.parent)
    while p is not None and p.name != name:
        p = by_id.get(p.parent)
    return p


def under(spans, name: str, ancestor: str) -> list:
    """The spans named ``name`` that have a span named ``ancestor`` above
    them."""
    by_id = {s.id: s for s in spans}
    return [s for s in spans
            if s.name == name and _above(by_id, s, ancestor) is not None]


def named(spans, name: str) -> list:
    return [s for s in spans if s.name == name]


def median_ms(spans):
    return 1e3 * statistics.median(s.seconds for s in spans) if spans \
        else None


def mean_ms(spans):
    return 1e3 * statistics.fmean(s.seconds for s in spans) if spans \
        else None


def gmres_self_ms(spans, ancestor: str):
    """GMRES's own time an iteration under ``ancestor``: the sum over its
    ``krylov.gmres`` spans of their duration less their ``krylov.matvec``
    and ``krylov.precond`` spans, over their ``krylov.iter`` spans."""
    by_id = {s.id: s for s in spans}
    solves = {s.id for s in under(spans, "krylov.gmres", ancestor)}
    own = sum(by_id[i].seconds for i in solves)
    iters = 0
    for s in spans:
        if s.name not in ("krylov.matvec", "krylov.precond", "krylov.iter"):
            continue
        solve = _above(by_id, s, "krylov.gmres")
        if solve is None or solve.id not in solves:
            continue
        if s.name == "krylov.iter":
            iters += 1
        else:
            own -= s.seconds
    return 1e3 * own / iters if iters else None


def per_span(spans, name: str, counter: str):
    """What ``counter`` counted inside the spans named ``name``, over their
    number."""
    sel = named(spans, name)
    return sum(s.count(counter) for s in sel) / len(sel) if sel else None
