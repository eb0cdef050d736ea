"""The residual-smoothing kernel (``csrc/residual_averaging.cu``): the bytes
and floating-point operations one launch needs, the smoothing of a block
of ni x nj x nk cells and nv channels along one axis. The block is read
once and written once, f32, beside the axis's (3, n) line factors, which
the count leaves out (at most 3 x 256 floats). Each value costs the
forward sweep's division, multiply and subtraction and the backward
sweep's multiply and subtraction: 5 operations, a division counting 1."""

ITEMSIZE = 4
FLOP_PER_VALUE = 5


def bytes_moved(ni, nj, nk, nv):
    return 2 * ni * nj * nk * nv * ITEMSIZE


def flops(ni, nj, nk, nv):
    return FLOP_PER_VALUE * ni * nj * nk * nv
