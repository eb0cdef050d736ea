"""The general part of the benchmark: it finds a cell's configuration,
traffic, driver, check and per-layer readers by the names in
``BENCHMARK.json``, runs the set-up, the measured window and the check, and
prints the result line. Nothing here belongs to one cell.

A run, in order:

1. the card is looked for; without as many cards as the cell asks for the
   run fails, and never falls back to the CPU;
2. set-up (``setup_s``, from the process's start): imports, the CUDA
   context, the kernels (built once into the program's ``build/`` in the
   checkout, loaded after that), the mesh from the benchmark's own
   generator, ``ADFLOW``, the seeded start and one warm-up unit of the
   cell's own work;
3. the window: whole units of work, one after another, until
   ``--seconds`` have passed; a unit begun is finished, and the window's
   time is that of its units;
4. with ``--trace 1``, the per-layer readers;
5. the program's state is freed and the check compares what the window
   produced with the plain reference (``benchmark/reference``);
6. the result line, and the compared numbers beside their limits.
"""

from __future__ import annotations

import argparse
import gc
import importlib.util
import json
import math
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "adflow_tpu")


# ---------------------------------------------------------------------------
# discovery by name
# ---------------------------------------------------------------------------

def load_benchmark() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def load_module(path: Path, name: str):
    """Import the file ``path`` as a module of its own (names may hold
    dots, as the metric ``idle.ank`` does)."""
    spec = importlib.util.spec_from_file_location(
        f"benchmark_{path.parent.name}_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def find_cell(bench: dict, name: str) -> SimpleNamespace:
    """The cell ``name``: its entry, its configuration's file and entry, its
    traffic file, and the per-layer metrics read in it."""
    cells = {c["name"]: c for c in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; the cells are "
                         f"{sorted(cells)}")
    cell = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    centry = configs[cell["config"]]
    config = json.loads((ROOT / centry["file"]).read_text())
    traffic = json.loads((BENCH / "workloads" / f"{name}.json").read_text())
    reports = {m["name"] for m in bench["end_to_end"]
               if name in m.get("workloads", [name])}
    per_layer = [m for m in bench["per_layer"] if name in m["workloads"]]
    return SimpleNamespace(name=name, entry=cell, config_entry=centry,
                           config=config, traffic=traffic,
                           end_to_end=[m for m in bench["end_to_end"]
                                       if m["name"] in reports],
                           per_layer=per_layer)


def driver_module(kind: str):
    return load_module(BENCH / "drivers" / f"{kind}.py", kind)


def check_module(kind: str):
    return load_module(BENCH / "checks" / f"{kind}.py", kind)


def reader_module(metric: str):
    return load_module(BENCH / "metrics" / f"{metric}.py", metric)


# ---------------------------------------------------------------------------
# the card
# ---------------------------------------------------------------------------

def require_cards(n: int):
    """Exit with code 2, printing no result, unless ``n`` CUDA cards are
    present."""
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < n:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"benchmark: the cell needs {n} CUDA card(s), {have} present",
              file=sys.stderr)
        raise SystemExit(2)


def power_limit() -> str:
    """The card's power limit as nvidia-smi prints it, or '' where it
    cannot be read."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.SubprocessError):
        return ""
    lines = out.stdout.strip().splitlines()
    return lines[0].strip() if out.returncode == 0 and lines else ""


WARM_S = 0.1     # seconds of warm-up calls before timing a piece


def time_ms(fn, reps=20, warmup=3):
    """Median ms of one call by CUDA events around each call, the calls
    queued back to back and synchronised once at the end (a copy of
    adflow_torch's ``utils/timing.time_ms``). Where the host launches
    faster than the device runs, each pair of events holds device time;
    where the host is slower (a chain of small launches, as every piece
    timed here), it holds the host's pace."""
    import torch
    t0 = time.perf_counter()
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    while time.perf_counter() - t0 < WARM_S:
        fn()
        torch.cuda.synchronize()
    events = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e) for s, e in events]))


# ---------------------------------------------------------------------------
# the device trace
# ---------------------------------------------------------------------------

def union_busy(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy


def summarize_trace(events, wall_s: float, span: str) -> dict:
    """The device's work in a traced piece from its device events
    (name, start_s, end_s): busy seconds (the union of the intervals),
    the idle share, seconds and launches by name, and the longest idle
    gaps between device operations, each labelled with the benchmark's
    span it fell in and the operation that ended it."""
    events = sorted(events, key=lambda e: e[1])
    busy = union_busy([(s, e) for _, s, e in events])
    by_name: dict = {}
    for name, s, e in events:
        t, c = by_name.get(name, (0.0, 0))
        by_name[name] = (t + (e - s), c + 1)
    gaps = []
    end = None
    for name, s, e in events:
        if end is not None and s > end:
            gaps.append((f"{span}: before {name}"[:120], s - end))
        end = e if end is None else max(end, e)
    gaps.sort(key=lambda g: -g[1])
    return {"busy_s": busy, "window_s": wall_s,
            "idle_pct": 100.0 * (1.0 - busy / wall_s) if wall_s > 0
            else None,
            "by_name": by_name, "gaps": gaps[:10], "n_ops": len(events)}


def profile(fn, span: str) -> dict:
    """``fn()`` under torch.profiler with device events only: the summary
    of ``summarize_trace``, the wall from a synchronised start to a
    synchronised end on the host's clock. No trace is written to disk."""
    import torch
    from torch.profiler import ProfilerActivity, profile as tprofile
    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    summary = summarize_trace(_device_events(prof), wall, span)
    print(f"benchmark: profiled {span}: wall {wall:.3f} s, "
          f"{summary['n_ops']} device ops, busy {summary['busy_s']:.3f} s; "
          f"the trace took {time.perf_counter() - t0 - wall:.1f} s more",
          file=sys.stderr)
    return summary


def _device_events(prof):
    """(name, start_s, end_s) of each device event of a finished profile;
    the raw kineto events where they are exposed (no tree of function
    events is built), else the profiler's own events."""
    import torch
    try:
        raw = prof.profiler.kineto_results.events()
    except AttributeError:
        raw = None
    out = []
    if raw is not None:
        for ev in raw:
            if ev.device_type() != torch.autograd.DeviceType.CUDA:
                continue
            s = ev.start_ns() * 1e-9
            out.append((ev.name(), s, s + ev.duration_ns() * 1e-9))
        return out
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            out.append((ev.name, ev.time_range.start * 1e-6,
                        ev.time_range.end * 1e-6))
    return out


def breakdown(summary: dict) -> dict:
    ops = sorted(summary["by_name"].items(), key=lambda kv: -kv[1][0])[:10]
    return {"device_ops": [[n[:120], t] for n, (t, _) in ops],
            "idle_gaps": [[n, t] for n, t in summary["gaps"]]}


# ---------------------------------------------------------------------------
# the run
# ---------------------------------------------------------------------------

def seeded_start(w_inf_flat: np.ndarray, nw: int, seed: int, amp: float):
    """The free stream plus ``amp`` times each channel's largest magnitude
    times seeded standard normal noise (float64, flat)."""
    w = w_inf_flat.reshape(-1, nw)
    rng = np.random.default_rng(seed % (1 << 64))
    return (w + amp * np.abs(w).max(axis=0)
            * rng.standard_normal(w.shape)).reshape(-1)


def forbidden_loaded():
    """Modules loaded whose top-level name is JAX's or the JAX package's."""
    return sorted({m for m in sys.modules
                   if m.split(".", 1)[0] in FORBIDDEN})


def parse_args(argv):
    ap = argparse.ArgumentParser(
        description="Run one cell of the benchmark of adflow_torch once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def run_cell(cell, seed: int, seconds: float, trace: bool, t_start: float,
             device: str = "cuda:0", mesh_dims=None, controls=()):
    """Set-up, window, readers and check of one cell; returns the result
    dict and the compared numbers [(name, value, limit)]. ``device`` and
    ``mesh_dims`` other than the cell's are for the CPU tests only.
    ``controls`` (the control script only): precisions, 'bfloat16' or
    'tf32', in which the reference is put in the program's place after the
    check; their readings go into the result under "controls"."""
    import torch
    cuda = torch.device(device).type == "cuda"
    driver = driver_module(cell.traffic["driver"])
    check = check_module(cell.traffic["check"]["kind"])
    ctx = SimpleNamespace(cell=cell, seed=seed, seconds=seconds,
                          trace=trace, device=device, cuda=cuda,
                          mesh_dims=mesh_dims,
                          expect_launches=cuda,
                          profile=None)
    check.install(ctx)
    st = driver.setup(ctx)
    check.begin(ctx)
    if cuda:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_start

    # the set-up's objects leave the collector's scans, so that a
    # collection in the window does not walk them
    gc.collect()
    gc.freeze()
    records = []
    t_window = time.perf_counter()
    while not records or time.perf_counter() - t_window < seconds:
        i = len(records)
        profiled = trace and cuda and i == cell.traffic["trace"]["unit"]
        t0 = time.perf_counter()
        if profiled:
            box = {}
            ctx.profile = profile(
                lambda: box.update(rec=driver.unit(ctx, st, i)),
                cell.traffic["trace"]["span"])
            rec = box["rec"]
        else:
            rec = driver.unit(ctx, st, i)
        if cuda:
            torch.cuda.synchronize()
        rec["seconds"] = time.perf_counter() - t0
        rec["profiled"] = profiled
        print(f"benchmark: unit {i}: {rec['seconds']:.3f} s; "
              f"{driver.describe(rec)}", file=sys.stderr)
        records.append(rec)
        check.after_unit(ctx, st, rec)
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    gc.unfreeze()

    failed = driver.failed_units(ctx, st, records)
    metrics = {}
    if not trace:
        metrics["setup_s"] = {"value": setup_s, "unit": "s"}
    for m in (cell.per_layer if trace else cell.end_to_end):
        if m["name"] == "setup_s":
            continue
        v = reader_module(m["name"]).read(ctx, st, records)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}

    t_readers = time.perf_counter()
    judged = check.collect(ctx, st, records)
    del st
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    compared = check.compare(ctx, judged)
    t_end = time.perf_counter()
    print(f"benchmark: set-up {setup_s:.3f} s, window "
          f"{t_readers - t_window:.3f} s ({len(records)} units), readers "
          f"and collection {t_check - t_readers:.3f} s, check "
          f"{t_end - t_check:.3f} s", file=sys.stderr)
    correct = (failed == 0 and all(
        math.isfinite(v) and v <= lim for _, v, lim in compared))

    devinfo = {"platform": "gpu" if cuda else "cpu",
               "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
               "count": int(cell.entry.get("chips", 1)),
               "memory_peak_bytes": int(peak)}
    if cuda:
        devinfo["power_limit"] = power_limit()
    if trace and ctx.profile is not None:
        devinfo["busy_s"] = ctx.profile["busy_s"]
        devinfo["window_s"] = ctx.profile["window_s"]
    result = {"correct": bool(correct), "attempted": len(records),
              "failed": int(failed), "metrics": metrics, "device": devinfo}
    if trace and ctx.profile is not None:
        result["breakdown"] = breakdown(ctx.profile)
    if controls:
        result["controls"] = {c: run_control(check, ctx, judged, c)
                              for c in controls}
    result["checks"] = {n: {"value": v, "limit": lim}
                        for n, v, lim in compared}
    return result, compared


def run_control(check, ctx, judged, name: str) -> dict:
    """The check's readings with the reference in precision ``name`` put
    in the program's place: 'bfloat16', or 'tf32' (float32 with TF32
    matrix products)."""
    import torch
    if name == "bfloat16":
        return check.control(ctx, judged, torch.bfloat16)
    if name != "tf32":
        raise ValueError(f"control precision {name!r}")
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    try:
        return check.control(ctx, judged, torch.float32)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False


def main(argv, t_start: float) -> int:
    args = parse_args(argv)
    bench = load_benchmark()
    cell = find_cell(bench, args.workload)
    require_cards(int(cell.entry.get("chips", 1)))
    result, compared = run_cell(cell, args.seed, args.seconds,
                                bool(args.trace), t_start)
    bad = forbidden_loaded()
    if bad:
        print(f"benchmark: JAX or the JAX package was loaded: {bad}",
              file=sys.stderr)
        return 3
    for n, v, lim in compared:
        print(f"check {n}: {v!r} (limit {lim!r})", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0
