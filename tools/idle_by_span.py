#!/usr/bin/env python3
"""The card's idle time put down to the program's spans, in one unit of a
cell of the benchmark:

    python3 tools/idle_by_span.py --workload <cell> [--seed N] [--out FILE]

from the root of a checkout, on a machine with a CUDA card. It builds the
cell as the benchmark does (``benchmark/harness.py`` and the cell's driver:
the mesh, ``ADFLOW``, the seeded start, the warm-up units), runs one unit
of the cell's work and then one more under ``torch.profiler`` with the
device's activity, as the benchmark's traced run profiles its second
unit, and joins the device's intervals with the spans of
``adflow_torch/utils/trace.py``, which share the profiler's clock. It
prints:

- the spans entered in the unit, by name, and whether they nest (every
  child inside its parent, the children's time within the parent's);
- the idle time under each innermost span: for each span name, the time
  its spans cover and no span under them does ("self"), and the part of
  it in which the card ran nothing; a span outside the cell's layers
  (``SPLIT``) is named with the layer above it ("halo.bc_pass <
  krylov.matvec"); "(no span)" is the unit's time outside every span;
- the same split by the cell's layers (``SPLIT``): a span of another name
  counts in the kept span above it, so a matvec holds its halo fills;
- for a Newton solve, each ``newton.step`` span beside its
  ``StepRecord.seconds``;
- the BC kernel's launches in each ``halo.bc_pass`` span
  (``bc_launches``), tallied by the nearest of the cell's layer spans
  above it;
- for a multigrid cell, each level's own part of the cycles (its
  ``mg.level.<n>`` spans less the coarser levels' and the transfers
  inside them): its time, K1's and the smoothing kernel's launches
  (``k1_launches``, ``irs_launches``) and the device operations that
  started in it, by name;
- the cell's per-layer metrics as the benchmark reads them from this
  unit.

``--out`` writes the same as JSON, with every span of the unit (name,
start and end in ns from the unit's start, id, parent, host syncs)."""

from __future__ import annotations

import argparse
import bisect
import collections
import json
import sys
import time
from pathlib import Path
from types import SimpleNamespace

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from benchmark import harness  # noqa: E402

API = ("api.solve", "api.set_states", "api.eval_functions",
       "api.eval_functions_sens")
KRYLOV = ("krylov.gmres", "krylov.iter", "krylov.matvec", "krylov.precond")
# the spans each traffic's split keeps
SPLIT = {
    "ank": API + ("newton.step", "newton.pc_build") + KRYLOV,
    "rk": API + ("smoother.cycle", "smoother.graph_capture", "halo.fill",
                 "halo.bc_pass"),
    "adjoint": API + ("adjoint.solve", "adjoint.pc_build") + KRYLOV,
    "fas": API + ("mg.cycle", "mg.transfer", "smoother.irs",
                  "smoother.graph_capture", "halo.fill", "halo.bc_pass")
    + tuple(f"mg.level.{n}" for n in range(8)),
}


# the spans ``bc_launches`` tallies a BC pass by
BC_PARENTS = API + ("smoother.cycle", "newton.step", "krylov.matvec",
                    "adjoint.solve", "adjoint.pc_build")


def merge(intervals):
    """The union of (start, end) intervals, as sorted disjoint ones."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


class Busy:
    """The card's busy time within any interval, from the union of its
    operations' intervals."""

    def __init__(self, intervals):
        self.union = merge(intervals)
        self.starts = [s for s, _ in self.union]
        self.ends = [e for _, e in self.union]
        self.cum = [0]
        for s, e in self.union:
            self.cum.append(self.cum[-1] + e - s)

    def within(self, a, b) -> int:
        i = bisect.bisect_right(self.ends, a)
        j = bisect.bisect_left(self.starts, b)
        if i >= j:
            return 0
        busy = self.cum[j] - self.cum[i]
        busy -= max(0, a - self.starts[i]) + max(0, self.ends[j - 1] - b)
        return busy


def uncovered(a: int, b: int, intervals) -> list:
    """The parts of [a, b] that none of ``intervals`` covers."""
    pieces, t = [], a
    for s, e in sorted(intervals):
        if s > t:
            pieces.append((t, min(s, b)))
        t = max(t, e)
        if t >= b:
            return pieces
    return pieces + [(t, b)]


def self_pieces(spans, keep=None) -> dict:
    """{span id: [(a, b), ...]}: the part of each kept span (every span
    with ``keep`` None) that no kept span under it covers."""
    by_id = {s.id: s for s in spans}
    kept = [s for s in spans if keep is None or s.name in keep]
    inner = collections.defaultdict(list)
    for s in kept:
        p = by_id.get(s.parent)
        while p is not None and keep is not None and p.name not in keep:
            p = by_id.get(p.parent)
        if p is not None:
            inner[p.id].append((s.start_ns, s.end_ns))
    return {s.id: uncovered(s.start_ns, s.end_ns, inner[s.id])
            for s in kept}


def split(spans, busy: Busy, t0: int, t1: int, keep=None,
          layers=()) -> dict:
    """{label: [count, self ns, idle ns]} over the kept spans, and
    "(no span)" for [t0, t1] outside every root span. A span's label is
    its name, and for a name not in ``layers`` the name of the nearest
    span above it that is."""
    by_id = {s.id: s for s in spans}
    rows = collections.defaultdict(lambda: [0, 0, 0])
    for sid, pieces in self_pieces(spans, keep).items():
        s = by_id[sid]
        label = s.name
        if layers and s.name not in layers:
            p = by_id.get(s.parent)
            while p is not None and p.name not in layers:
                p = by_id.get(p.parent)
            label += f" < {p.name if p is not None else '-'}"
        row = rows[label]
        row[0] += 1
        for a, b in pieces:
            row[1] += b - a
            row[2] += (b - a) - busy.within(a, b)
    row = rows["(no span)"]
    for a, b in uncovered(t0, t1, [(s.start_ns, s.end_ns) for s in spans
                                   if s.parent == 0]):
        row[1] += b - a
        row[2] += (b - a) - busy.within(a, b)
    return dict(rows)


def nesting_faults(spans) -> list:
    """Children outside their parent, or whose time exceeds the
    parent's."""
    by_id = {s.id: s for s in spans}
    kids = collections.defaultdict(list)
    for s in spans:
        kids[s.parent].append(s)
    faults = []
    for pid, cs in kids.items():
        if pid == 0:
            continue
        p = by_id.get(pid)
        if p is None:
            faults.append(f"parent {pid} of {cs[0].name} not recorded")
            continue
        if any(not (p.start_ns <= c.start_ns <= c.end_ns <= p.end_ns)
               for c in cs):
            faults.append(f"a child of {p.name} {p.id} outside it")
        if sum(c.end_ns - c.start_ns for c in cs) > p.end_ns - p.start_ns:
            faults.append(f"children of {p.name} {p.id} longer than it")
    return faults


def device_intervals(prof):
    """(start_ns, end_ns) of every device event of a finished profile, the
    events the benchmark's busy time counts."""
    import torch
    return [(ev.start_ns(), ev.start_ns() + ev.duration_ns())
            for ev in prof.profiler.kineto_results.events()
            if ev.device_type() == torch.autograd.DeviceType.CUDA]


def table(rows: dict, wall_ns: int) -> list:
    return [{"span": n, "count": c, "self_ms": s * 1e-6,
             "idle_ms": i * 1e-6, "idle_pct_of_unit": 100.0 * i / wall_ns}
            for n, (c, s, i) in sorted(rows.items(), key=lambda kv: -kv[1][2])]


def bc_launches(spans, layers) -> dict:
    """For each span name of ``layers``, how many ``halo.bc_pass`` spans
    under it (the nearest above them) launched the BC kernel how many
    times: {name: {launches: passes}}. Empty for a program without the
    counter."""
    by_id = {s.id: s for s in spans}
    out = collections.defaultdict(collections.Counter)
    for s in spans:
        if s.name != "halo.bc_pass" or "bc_launches" not in s.enter:
            continue
        up = by_id.get(s.parent)
        while up is not None and up.name not in layers:
            up = by_id.get(up.parent)
        out[up.name if up else "(no span)"][s.count("bc_launches")] += 1
    return {k: dict(v) for k, v in out.items()}


def mg_levels(spans, events) -> dict:
    """For each multigrid level, its own part of the unit (the
    ``mg.level.<n>`` spans less the level and transfer spans inside them):
    {level: {own_ms, k1_launches, irs_launches, device_ops, top_ops}},
    the device operations counted by the start of each inside the own
    part (a launch's operation runs after its launch, so this is near,
    not exact, where the card queues work). Empty without such spans."""
    keep = {s.name for s in spans
            if s.name.startswith("mg.level.") or s.name == "mg.transfer"}
    if not keep:
        return {}
    by_id = {s.id: s for s in spans}
    own = self_pieces(spans, keep)
    pieces = []
    for sid, ps in own.items():
        s = by_id[sid]
        if s.name.startswith("mg.level."):
            pieces += [(a, b, int(s.name.rsplit(".", 1)[1])) for a, b in ps]
    pieces.sort()
    starts = [p[0] for p in pieces]
    out = {}
    for sid, ps in own.items():
        s = by_id[sid]
        if not s.name.startswith("mg.level."):
            continue
        lev = int(s.name.rsplit(".", 1)[1])
        row = out.setdefault(lev, {"own_ms": 0.0, "k1_launches": 0,
                                   "irs_launches": 0, "device_ops": 0,
                                   "ops": collections.Counter()})
        row["own_ms"] += sum(b - a for a, b in ps) * 1e-6
        k1, irs = s.count("k1_launches"), s.count("irs_launches")
        for c in spans:
            p = by_id.get(c.parent)
            while p is not None and p.name not in keep:
                p = by_id.get(p.parent)
            if p is not None and p.id == sid and c.name in keep:
                k1 -= c.count("k1_launches")
                irs -= c.count("irs_launches")
        row["k1_launches"] += k1
        row["irs_launches"] += irs
    for name, a, _ in events:
        i = bisect.bisect_right(starts, a) - 1
        if i >= 0 and pieces[i][0] <= a < pieces[i][1]:
            row = out[pieces[i][2]]
            row["device_ops"] += 1
            row["ops"][name[:60]] += 1
    for row in out.values():
        row["top_ops"] = row.pop("ops").most_common(8)
    return dict(sorted(out.items()))


def report(cell, ctx, st, driver) -> dict:
    """Run a unit of the built cell under the profiler and join."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from adflow_torch.utils import trace

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.time_ns()
        rec = driver.unit(ctx, st, 1)
        torch.cuda.synchronize()
        t1 = time.time_ns()
    spans = trace.spans()
    busy = Busy(device_intervals(prof))
    ctx.profile = harness.summarize_trace(
        harness._device_events(prof), (t1 - t0) * 1e-9,
        cell.traffic["trace"]["span"])
    rec["seconds"], rec["profiled"] = (t1 - t0) * 1e-9, True
    layers = SPLIT[cell.entry["traffic"]]
    out = {
        "cell": cell.name, "seed": ctx.seed, "wall_ms": (t1 - t0) * 1e-6,
        "busy_ms": busy.cum[-1] * 1e-6, "device_ops": ctx.profile["n_ops"],
        "spans": len(spans), "dropped": trace.dropped,
        "by_name": dict(collections.Counter(s.name for s in spans)),
        "nesting_faults": nesting_faults(spans),
        "idle_by_innermost_span": table(split(spans, busy, t0, t1,
                                              layers=layers), t1 - t0),
        "split": table(split(spans, busy, t0, t1, keep=layers), t1 - t0),
        "bc_launches": bc_launches(spans, BC_PARENTS),
        "mg_levels": mg_levels(spans, [
            (ev.name(), ev.start_ns(), ev.start_ns() + ev.duration_ns())
            for ev in prof.profiler.kineto_results.events()
            if ev.device_type() == torch.autograd.DeviceType.CUDA]),
        "raw": [[s.name, s.start_ns - t0, s.end_ns - t0, s.id, s.parent,
                 s.count("host_syncs")] for s in spans],
    }
    info = rec.get("info")
    if info is not None and info.steps:
        steps = sorted((s for s in spans if s.name == "newton.step"),
                       key=lambda s: s.start_ns)
        out["steps"] = [{"span_ms": s.seconds * 1e3,
                         "record_ms": r.seconds * 1e3,
                         "rel": s.seconds / r.seconds - 1.0,
                         "matvecs": r.krylov_matvecs,
                         "host_syncs": s.count("host_syncs")}
                        for s, r in zip(steps, info.steps)]
    out["metrics"] = {
        m["name"]: harness.reader_module(m["name"]).read(ctx, st, [rec])
        for m in cell.per_layer}
    return out


def build(name: str, seed: int):
    """The cell ``name`` built as the benchmark builds it: (cell, ctx,
    state, driver)."""
    cell = harness.find_cell(harness.load_benchmark(), name)
    harness.require_cards(int(cell.entry.get("chips", 1)))
    ctx = SimpleNamespace(cell=cell, seed=seed, seconds=0.0, trace=True,
                          device="cuda:0", cuda=True, mesh_dims=None,
                          expect_launches=True, profile=None)
    driver = harness.driver_module(cell.traffic["driver"])
    return cell, ctx, driver.setup(ctx), driver


def print_report(out: dict):
    print(f"{out['cell']} seed {out['seed']}: wall {out['wall_ms']:.1f} ms, "
          f"busy {out['busy_ms']:.1f} ms, {out['device_ops']} device ops, "
          f"{out['spans']} spans ({out['dropped']} dropped), nesting "
          f"faults: {out['nesting_faults'] or 'none'}")
    print("  spans:", json.dumps(out["by_name"]))
    for key in ("idle_by_innermost_span", "split"):
        print(f"  {key}: span, count, self ms, idle ms, idle % of the unit")
        for r in out[key]:
            print(f"    {r['span']:<40} {r['count']:>6} "
                  f"{r['self_ms']:>11.2f} {r['idle_ms']:>11.2f} "
                  f"{r['idle_pct_of_unit']:>7.2f}")
    for s in out.get("steps", []):
        print(f"  newton.step {s['span_ms']:.2f} ms, StepRecord "
              f"{s['record_ms']:.2f} ms ({100 * s['rel']:+.3f}%), "
              f"{s['matvecs']} matvecs, {s['host_syncs']} host syncs")
    print("  bc_launches by layer span, {launches: passes}:",
          json.dumps(out["bc_launches"]))
    for lev, row in out["mg_levels"].items():
        print(f"  mg level {lev}: own {row['own_ms']:.1f} ms, K1 "
              f"{row['k1_launches']}, smoothing {row['irs_launches']} "
              f"launches, {row['device_ops']} device ops; top "
              f"{json.dumps(row['top_ops'])}")
    print("  metrics:", json.dumps(out["metrics"]))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, default=4700000001)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    cell, ctx, st, driver = build(args.workload, args.seed)
    driver.unit(ctx, st, 0)
    out = report(cell, ctx, st, driver)
    print_report(out)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
