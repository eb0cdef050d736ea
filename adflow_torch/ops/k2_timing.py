"""Time K2 on the card for a few segment lengths.

    python -m adflow_torch.ops.k2_timing [--dims NI NJ NK] [SI ...]

Each SI is a segment length to try; without one, the segment
``cuda_inviscid.k2_tile_plan`` picks. Builds K2, prints what ``-Xptxas -v``
says of it, and on the ``sample_operands`` block (256x64x64 by default)
checks each plan against the plain version (1e-4 per channel, as
``chip_smoke.py`` does) and against a second launch (bitwise equal), then
times it (CUDA events, median of 20) beside the plain version and the byte
bound. Exits with 1 without a card, and with an assertion if a check fails.
"""

from __future__ import annotations

import sys

from adflow_torch.ops import cuda_inviscid
from adflow_torch.utils.timing import plan_timing


def main(argv=None) -> int:
    return plan_timing(argv, __doc__, "K2", cuda_inviscid,
                       cuda_inviscid.k2_tile_plan,
                       cuda_inviscid.inviscid_residual_reference)


if __name__ == "__main__":
    sys.exit(main())
