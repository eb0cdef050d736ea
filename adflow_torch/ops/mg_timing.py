"""Time the multigrid levels' kernels on the card: K1's coarse-level
instantiation and the residual-smoothing kernel.

    python -m adflow_torch.ops.mg_timing [--dims NI NJ NK ...]

For each block size (default: the three levels of the 256x64x64 wing,
256x64x64, 128x32x32 and 64x16x16), on the ``cuda_rans.sample_operands``
block: K1 with ``coarse`` (vis2Coarse 0.5) against the float64 plain coarse
residual (each channel within 2e-5 of its largest magnitude, or twice the
plain float32 version's distance) and against a second launch (bitwise
equal); the smoothing of a seeded (ni, nj, nk, 6) block along its three
axes against the float64 plain sweeps (1e-6 of each channel's largest
magnitude). Then each is timed: CUDA events (median of 20, back to back)
and the profiler's device time a call, beside its byte bound and the plain
version's times. Builds both sources and prints what ``-Xptxas -v`` says
of them. Exits with 1 without a card, and with an assertion if a check
fails.
"""

from __future__ import annotations

import argparse
import sys

import torch

from adflow_torch.ops import _nvcc, cuda_irs, cuda_rans
from adflow_torch.ops.bc_timing import device_ms, rel_per_channel
from adflow_torch.utils.timing import HBM_BYTES_PER_S, card_line, time_ms

LEVELS = ((256, 64, 64), (128, 32, 32), (64, 16, 16))
VIS2_COARSE = 0.5
NV = 6


def k1_coarse(dims, device) -> dict:
    """K1's coarse instantiation at ``dims`` against the float64 plain
    coarse residual on the same float32 inputs and a second launch; its
    times. Returns what it printed."""
    tensors, consts = cuda_rans.sample_operands(dims, device)
    consts = (VIS2_COARSE,) + tuple(consts[1:])

    def kernel():
        return cuda_rans.fused_rans_residual(*tensors, *consts, coarse=True)

    def plain():
        return cuda_rans.rans_residual_reference(*tensors, *consts,
                                                 coarse=True)

    got, again = kernel(), kernel()
    want = cuda_rans.rans_residual_reference(
        *[t.double() for t in tensors], *consts, coarse=True)
    errs, errs32 = rel_per_channel(want, got), rel_per_channel(want, plain())
    assert torch.equal(got, again)
    assert all(e < max(2e-5, 2.0 * p) for e, p in zip(errs, errs32)), (
        errs, errs32)
    out = dict(rel_err=max(errs), plain_rel_err=max(errs32),
               ms=time_ms(kernel), device_ms=device_ms(kernel),
               bound_ms=cuda_rans.min_bytes(*dims) / HBM_BYTES_PER_S * 1e3,
               plain_ms=time_ms(plain, reps=5),
               plain_device_ms=device_ms(plain, reps=3))
    print(f"  K1 coarse {'x'.join(map(str, dims))}: from float64 "
          f"{out['rel_err']:.3e} (plain float32 {out['plain_rel_err']:.3e}); "
          f"events {out['ms']:.4f} ms, device {out['device_ms']:.4f} ms a "
          f"launch; byte bound {out['bound_ms']:.4f} ms; plain events "
          f"{out['plain_ms']:.3f} ms, device {out['plain_device_ms']:.3f} ms")
    return out


def smoothing(dims, device) -> dict:
    """The smoothing kernel on a seeded (dims, NV) block along its three
    axes against the float64 plain sweeps on the same float32 input; its
    launches and times. Returns what it printed."""
    gen = torch.Generator(device=device).manual_seed(11)
    r = torch.randn(tuple(dims) + (NV,), generator=gen, device=device)

    def kernel():
        return cuda_irs.smooth(r, 0.5)

    def plain():
        return cuda_irs.irs_reference(r, 0.5)

    n0 = cuda_irs.LAUNCHES
    got = kernel()
    torch.cuda.synchronize()
    launches = cuda_irs.LAUNCHES - n0
    want = cuda_irs.irs_reference(r.double(), 0.5)
    errs = rel_per_channel(want, got)
    assert max(errs) < 1e-6, errs
    assert launches == 3, launches
    # r read and x written once a launch (benchmark/roofline/irs.py)
    out = dict(launches=launches, rel_err=max(errs), ms=time_ms(kernel),
               device_ms=device_ms(kernel),
               bound_ms=launches * 2 * r.numel() * r.element_size()
               / HBM_BYTES_PER_S * 1e3,
               plain_ms=time_ms(plain, reps=5),
               plain_device_ms=device_ms(plain, reps=3))
    print(f"  smoothing {'x'.join(map(str, dims))}x{NV}: {launches} "
          f"launches, from float64 {out['rel_err']:.3e}; events "
          f"{out['ms']:.4f} ms, device {out['device_ms']:.4f} ms a call; "
          f"byte bound {out['bound_ms']:.4f} ms; plain events "
          f"{out['plain_ms']:.3f} ms, device {out['plain_device_ms']:.3f} ms")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dims", type=int, nargs=3, action="append")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("mg_timing: needs a CUDA card", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    print(card_line())
    _nvcc.build_all([cuda_rans.SRC, cuda_irs.SRC])
    for src in (cuda_rans.SRC, cuda_irs.SRC):
        for line in _nvcc.ptxas_report(src):
            print(f"  {src.name}: {line}")
    for dims in args.dims or LEVELS:
        k1_coarse(tuple(dims), device)
        smoothing(tuple(dims), device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
