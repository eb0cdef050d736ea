"""Time the BC pass kernel on the card.

    python -m adflow_torch.ops.bc_timing [--dims NI NJ NK] [NW ...]

Each NW is a channel count to run (5 Euler, 6 SA, 7 SST; default 5 and 6).
Builds ``csrc/bc_ghost.cu`` and prints what ``-Xptxas -v`` says of it. On
the ``cuda_bc.sample_pass`` wing (256x64x64 by default) it checks the
kernel pass against the plain pass in float64 on the same float32 inputs
(each channel within ``FULL_RTOL`` of its largest magnitude, as
``chip_smoke.py`` holds K1 and K2 to their plain versions; the plain
float32 pass's distance is printed beside it) and against a second kernel
pass (bitwise equal), then times the kernel pass,
its jvp (the forward's and the tangent's launches), the plain pass and the
plain pass's jvp: CUDA events (median of 20, back to back) and the
profiler's device time a pass (every device operation of the pass: the
clone and one launch a subface), beside the byte bound (the clone: ``cuda_bc.min_bytes``). Exits with 1 without a
card, and with an assertion if a check fails.
"""

from __future__ import annotations

import argparse
import sys

import torch

from adflow_torch.ops import _nvcc, cuda_bc
from adflow_torch.physics import bc
from adflow_torch.utils.timing import (
    FULL_RTOL, HBM_BYTES_PER_S, card_line, time_ms)

REPS = 20


def rel_per_channel(want, got):
    """Each channel's largest difference over its largest magnitude."""
    want, got = want.double(), got.double()
    scale = want.abs().amax(dim=(0, 1, 2)) + 1e-30
    return ((got - want).abs().amax(dim=(0, 1, 2)) / scale).tolist()


def device_ms(fn, reps=REPS):
    """The device's busy time a call of ``fn`` by torch.profiler: the sum
    of the device operations of ``reps`` calls, over ``reps``."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               ) / 1e3 / reps


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dims", type=int, nargs=3, default=(256, 64, 64))
    ap.add_argument("nw", type=int, nargs="*")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("BC pass timing: no CUDA device", file=sys.stderr)
        return 1
    dims = tuple(args.dims)
    print(card_line())
    cuda_bc._lib()
    for line in _nvcc.ptxas_report(cuda_bc.SRC):
        print(f"  {line}")
    for nw in args.nw or [5, 6]:
        w, m, ops, ref, winf = cuda_bc.sample_pass(dims, nw, "cuda:0")
        v = torch.randn_like(w)

        def kernel():
            return cuda_bc.fused_bc_pass(w, m, ops, ref, winf)

        def plain():
            return cuda_bc.bc_pass_reference(w, m, ops, ref, winf)

        def jvp(pass_fn):
            return lambda: torch.func.jvp(
                lambda w: pass_fn(w, m, ops, ref, winf), (w,), (v,))

        got, again, want = kernel(), kernel(), plain()
        exact = cuda_bc.bc_pass_reference(
            w.double(), m._replace(siE=m.siE.double(), sjE=m.sjE.double(),
                                   skE=m.skE.double()),
            ops, ref, winf.double())
        torch.cuda.synchronize()
        k_err = rel_per_channel(exact, got)
        p_err = rel_per_channel(exact, want)
        bound = cuda_bc.min_bytes(w) / HBM_BYTES_PER_S * 1e3
        n_ops = len(bc.physical_ops(ops))
        print(f"BC pass at {dims}, nw {nw}, {n_ops} subfaces: byte bound "
              f"{bound:.4f} ms ({cuda_bc.min_bytes(w) / 1e6:.1f} MB); rel "
              f"err against float64 {max(k_err):.3e} (plain float32 "
              f"{max(p_err):.3e}); bitwise equal "
              f"{bool(torch.equal(got, again))}")
        for name, fn in (("kernel pass", kernel),
                         ("kernel jvp", jvp(cuda_bc.fused_bc_pass)),
                         ("plain pass", plain),
                         ("plain jvp", jvp(cuda_bc.bc_pass_reference))):
            ms, dev = time_ms(fn), device_ms(fn)
            print(f"  {name}: events {ms:.4f} ms, device {dev:.4f} ms "
                  f"({dev / bound:.2f}x the bound)")
        assert max(k_err) < FULL_RTOL, k_err
        assert torch.equal(got, again)
    return 0


if __name__ == "__main__":
    sys.exit(main())
