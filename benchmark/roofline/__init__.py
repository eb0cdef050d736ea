"""Rooflines of the program's kernels: one module per kernel with its
bytes and operations as functions of the block's dims, and the card's
peaks (``peaks.json``)."""

from __future__ import annotations

import importlib
import json
from pathlib import Path

PEAKS = json.loads((Path(__file__).with_name("peaks.json")).read_text())


def least_seconds(kernel: str, dims) -> float:
    """The least time of one launch on a block of ``dims``: the larger of
    its bytes over the HBM bandwidth and its operations over the f32 peak
    (no tensor core applies to a stencil)."""
    mod = importlib.import_module(f"benchmark.roofline.{kernel}")
    return max(mod.bytes_moved(*dims) / PEAKS["hbm_bytes_per_s"],
               mod.flops(*dims) / PEAKS["fp32_flop_per_s"])


def share(ctx, kernel: str, device_name: str):
    """The kernel's share of its roofline in percent, from the profiled
    unit's device time a launch of the kernel named ``device_name``; None
    where the profile holds no such launch."""
    prof = ctx.profile
    if prof is None:
        return None
    hits = [(t, c) for name, (t, c) in prof["by_name"].items()
            if device_name in name]
    if not hits:
        return None
    t = sum(h[0] for h in hits)
    c = sum(h[1] for h in hits)
    m = ctx.cell.config["mesh"]
    dims = ctx.mesh_dims or (m["ni"], m["nj"], m["nk"])
    return 100.0 * least_seconds(kernel, dims) / (t / c)
