"""What the multigrid cell's in-loop readers share: the work of each level
and of the transfers in the profiled unit, from the program's spans
``mg.cycle``, ``mg.level.<n>``, ``mg.transfer`` and ``smoother.irs``
(``adflow_torch/solvers/multigrid.py``), and the halo spans under
``mg.cycle``. A level's span holds the spans of
the coarser levels it visits and the transfers between them; its own part
is what is left of it without those: its smoothing sweeps, its residuals,
its halo fills. Where the profiled unit has no such spans (a program
without them) every function here gives None."""

from __future__ import annotations

from benchmark import spans as _spans

LEVEL = "mg.level."


def _level(name: str):
    return int(name[len(LEVEL):]) if name.startswith(LEVEL) else None


def split(ctx):
    """(cycles, {level: [own seconds, own K1 launches, own smoothing
    launches]}, transfer seconds) of the profiled unit, or None."""
    sp = _spans.profiled(ctx)
    if not sp:
        return None
    cycles = len(_spans.named(sp, "mg.cycle"))
    if not cycles:
        return None
    by_id = {s.id: s for s in sp}
    own = {}
    for s in sp:
        if _level(s.name) is not None:
            own[s.id] = [s.seconds, s.count("k1_launches"),
                         s.count("irs_launches")]
    transfer = 0.0
    for s in sp:
        if _level(s.name) is None and s.name != "mg.transfer":
            continue
        if s.name == "mg.transfer":
            transfer += s.seconds
        up = by_id.get(s.parent)
        while up is not None and _level(up.name) is None:
            up = by_id.get(up.parent)
        if up is None:
            continue
        mine = own[up.id]
        mine[0] -= s.seconds
        if s.id in own:
            mine[1] -= s.count("k1_launches")
            mine[2] -= s.count("irs_launches")
    levels = {}
    for i, (t, k1, irs) in own.items():
        lev = _level(by_id[i].name)
        acc = levels.setdefault(lev, [0.0, 0, 0])
        acc[0] += t
        acc[1] += k1
        acc[2] += irs
    return cycles, levels, transfer


def smoothing_median_ms(ctx):
    """The median ``smoother.irs`` span of the profiled unit in ms, or
    None."""
    sp = _spans.profiled(ctx)
    return sp and _spans.median_ms(_spans.named(sp, "smoother.irs"))


def per_cycle_ms(ctx, name: str):
    """The ``name`` spans under ``mg.cycle`` in the profiled unit, summed,
    in ms over the ``mg.cycle`` spans, or None."""
    sp = _spans.profiled(ctx)
    cycles = sp and len(_spans.named(sp, "mg.cycle"))
    if not cycles:
        return None
    return 1e3 * sum(s.seconds for s in _spans.under(sp, name, "mg.cycle")) \
        / cycles


def level_dims(ctx, lev: int) -> tuple:
    """The cell's block dims on level ``lev``: each axis halved ``lev``
    times where it is even and longer than 1 (the program's
    ``coarsen_factors``)."""
    m = ctx.cell.config["mesh"]
    dims = list(ctx.mesh_dims or (m["ni"], m["nj"], m["nk"]))
    for _ in range(lev):
        dims = [d // 2 if (d > 1 and d % 2 == 0) else d for d in dims]
    return tuple(dims)


def n_channels(ctx) -> int:
    """The state's channels: 6 for RANS-SA, else 5."""
    return 6 if str(ctx.cell.config["equationType"]).lower() == "rans" \
        else 5


def device_seconds(ctx, device_name: str):
    """The profiled unit's device seconds of the kernels named
    ``device_name``, or None."""
    prof = ctx.profile
    if prof is None:
        return None
    hits = [t for name, (t, _) in prof["by_name"].items()
            if device_name in name]
    return sum(hits) if hits else None
