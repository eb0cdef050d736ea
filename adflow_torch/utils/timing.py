"""Timing on the card: the card's name and power limit, and CUDA-event
medians. Used by ``chip_smoke.py`` and ``python -m adflow_torch.ops.k1_timing``;
nothing here runs when the module is imported."""

from __future__ import annotations

import subprocess

import numpy as np
import torch


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
    small launches), it holds the host's pace."""
    for _ in range(warmup):
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
