"""Time K1 on the card for a few segment lengths.

    python -m adflow_torch.ops.k1_timing [--dims NI NJ NK] [SI ...]

Each SI is a segment length to try; without one, the segment
``cuda_rans.k1_tile_plan`` picks. Builds K1, prints what ``-Xptxas -v``
says of it, and on the ``sample_operands`` block (256x64x64 by
default) checks each plan against the plain version (1e-4 per channel, as
``chip_smoke.py`` does at the full size) and against a second launch (bitwise
equal), then times it (CUDA events, median of 20) beside the plain version
and the byte bound. Exits with 1 without a card, and with an assertion if a
check fails.
"""

from __future__ import annotations

import argparse
import sys

import torch

from adflow_torch.ops import cuda_rans
from adflow_torch.utils.timing import card_line, time_ms

FULL_RTOL = 1e-4
HBM_BYTES_PER_S = 3.35e12      # H100 SXM, NVIDIA's data sheet


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dims", type=int, nargs=3, default=(256, 64, 64))
    ap.add_argument("segments", type=int, nargs="*")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("k1_timing: no CUDA device", file=sys.stderr)
        return 1
    dims = tuple(args.dims)
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    plans = [cuda_rans.k1_tile_plan(*dims, si=si, n_sm=n_sm)
             for si in args.segments or [None]]
    print(card_line())
    cuda_rans._lib()
    for line in cuda_rans.ptxas_report():
        print(f"  {line}")

    tensors, consts = cuda_rans.sample_operands(dims, "cuda:0")
    want = cuda_rans.rans_residual_reference(*tensors, *consts)
    plain_ms = time_ms(
        lambda: cuda_rans.rans_residual_reference(*tensors, *consts))
    bound_ms = cuda_rans.min_bytes(*dims) / HBM_BYTES_PER_S * 1e3
    print(f"dims {dims}: plain {plain_ms:.4f} ms, byte bound "
          f"{bound_ms:.4f} ms")
    for plan in plans:
        got = cuda_rans._launch(tensors, *consts, plan=plan)
        again = cuda_rans._launch(tensors, *consts, plan=plan)
        torch.cuda.synchronize()
        scale = want.double().abs().amax(dim=(0, 1, 2)) + 1e-30
        rel = ((got.double() - want.double()).abs().amax(dim=(0, 1, 2))
               / scale).tolist()
        ms = time_ms(lambda: cuda_rans._launch(tensors, *consts, plan=plan))
        print(f"  tile {plan.tj}x{plan.tk}, {plan.threads} threads, "
              f"segment {plan.si}, grid "
              f"{plan.grid}, {plan.smem_bytes} B shared, copy "
              f"{plan.copy_width} B: {ms:.4f} ms ({ms / bound_ms:.2f}x the "
              f"bound); rel err {max(rel):.3e}; bitwise equal "
              f"{bool(torch.equal(got, again))}")
        assert max(rel) < FULL_RTOL, rel
        assert torch.equal(got, again)
    return 0


if __name__ == "__main__":
    sys.exit(main())
