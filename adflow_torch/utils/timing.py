"""Timing on the card: the card's name and power limit, CUDA-event medians
and the body of the kernels' timing scripts. Used by ``chip_smoke.py`` and
``python -m adflow_torch.ops.k1_timing`` / ``k2_timing``; nothing here runs
when the module is imported."""

from __future__ import annotations

import argparse
import subprocess
import sys
import time

import numpy as np
import torch

FULL_RTOL = 1e-4               # kernel vs plain, f32, at 256x64x64
WARM_S = 0.1                   # seconds of warm-up calls before timing
HBM_BYTES_PER_S = 3.35e12      # H100 SXM, NVIDIA's data sheet


def card_line() -> str:
    """``name, power.limit`` of card 0, as nvidia-smi prints them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def time_ms(fn, reps=20, warmup=3):
    """Median time of one call, by CUDA events around each call. The calls
    are queued back to back and synchronised once at the end, so where the
    host launches faster than the device runs (a kernel), each pair of
    events holds device time only; where the host is slower (a chain of
    small launches), it holds the host's pace. The warm-up runs ``warmup``
    calls and then more until ``WARM_S`` seconds have passed: a card left
    idle by host-bound work clocks down, and a few calls of a 0.1 ms kernel
    run before its clocks are back."""
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


def plan_timing(argv, doc, name, mod, plan_fn, plain):
    """The body of ``python -m adflow_torch.ops.k1_timing`` and
    ``k2_timing`` (``doc`` is the script's docstring): build the kernel of
    ``mod`` (its ``SRC``, ``_lib``, ``_launch``, ``sample_operands`` and
    ``min_bytes``), print its ``-Xptxas -v`` lines, and on the
    ``sample_operands`` block check each plan of ``plan_fn`` (one per
    segment length given, else the default) against the plain version
    ``plain`` (``FULL_RTOL`` per channel, relative to the plain result's
    largest value) and a second launch (bitwise equal),
    then time it beside the plain version and the byte bound. Returns the
    exit code: 1 without a card; a failed check raises."""
    from adflow_torch.ops import _nvcc

    ap = argparse.ArgumentParser(description=doc.splitlines()[0])
    ap.add_argument("--dims", type=int, nargs=3, default=(256, 64, 64))
    ap.add_argument("segments", type=int, nargs="*")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print(f"{name} timing: no CUDA device", file=sys.stderr)
        return 1
    dims = tuple(args.dims)
    n_sm = _nvcc.n_sm(0)
    plans = [plan_fn(*dims, si=si, n_sm=n_sm)
             for si in args.segments or [None]]
    print(card_line())
    mod._lib()
    for line in _nvcc.ptxas_report(mod.SRC):
        print(f"  {line}")

    tensors, consts = mod.sample_operands(dims, "cuda:0")
    want = plain(*tensors, *consts)
    plain_ms = time_ms(lambda: plain(*tensors, *consts))
    bound_ms = mod.min_bytes(*dims) / HBM_BYTES_PER_S * 1e3
    print(f"{name} at {dims}: plain {plain_ms:.4f} ms, byte bound "
          f"{bound_ms:.4f} ms")
    for plan in plans:
        got = mod._launch(tensors, *consts, plan=plan)
        again = mod._launch(tensors, *consts, plan=plan)
        torch.cuda.synchronize()
        scale = want.double().abs().amax(dim=(0, 1, 2)) + 1e-30
        rel = ((got.double() - want.double()).abs().amax(dim=(0, 1, 2))
               / scale).tolist()
        ms = time_ms(lambda: mod._launch(tensors, *consts, plan=plan))
        print(f"  tile {plan.tj}x{plan.tk}, {plan.threads} threads, "
              f"segment {plan.si}, grid {plan.grid}, {plan.smem_bytes} B "
              f"shared, copy {plan.copy_width} B: {ms:.4f} ms "
              f"({ms / bound_ms:.2f}x the bound); rel err {max(rel):.3e}; "
              f"bitwise equal {bool(torch.equal(got, again))}")
        assert max(rel) < FULL_RTOL, rel
        assert torch.equal(got, again)
    return 0
