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

import sys

from adflow_torch.ops import cuda_rans
from adflow_torch.utils.timing import plan_timing


def main(argv=None) -> int:
    return plan_timing(argv, __doc__, "K1", cuda_rans,
                       cuda_rans.k1_tile_plan,
                       cuda_rans.rans_residual_reference)


if __name__ == "__main__":
    sys.exit(main())
