"""K2, the JST inviscid residual kernel (``csrc/inviscid_residual.cu``):
the bytes and floating-point operations one launch needs on a block of
ni x nj x nk cells, counted from the operands the wrapper
``fused_inviscid_residual`` passes. Each input byte counts once and the
output once; f32 throughout. The operations are the arithmetic of the
plain version: per one-ring extended cell (velocity, sound speed, the
pressure sensor in three directions, three radii and their directional
scaling), per face (central flux and JST dissipation of five channels)
and per interior cell (face differences); a transcendental counts 1."""

ITEMSIZE = 4
FLOP_PER_EXT_CELL = 90
FLOP_PER_FACE = 95
FLOP_PER_CELL = 30


def operand_shapes(ni, nj, nk):
    return {
        "w5": (ni + 4, nj + 4, nk + 4, 5),
        "p": (ni + 4, nj + 4, nk + 4),
        "siE": (ni + 3, nj + 2, nk + 2, 3),
        "sjE": (ni + 2, nj + 3, nk + 2, 3),
        "skE": (ni + 2, nj + 2, nk + 3, 3),
        "porI": (ni + 1, nj, nk),
        "porJ": (ni, nj + 1, nk),
        "porK": (ni, nj, nk + 1),
        "out": (ni, nj, nk, 5),
    }


def bytes_moved(ni, nj, nk):
    total = 0
    for shape in operand_shapes(ni, nj, nk).values():
        n = 1
        for s in shape:
            n *= s
        total += n
    return total * ITEMSIZE


def flops(ni, nj, nk):
    n_ext = (ni + 2) * (nj + 2) * (nk + 2)
    n_faces = (ni + 1) * nj * nk + ni * (nj + 1) * nk + ni * nj * (nk + 1)
    return (FLOP_PER_EXT_CELL * n_ext + FLOP_PER_FACE * n_faces
            + FLOP_PER_CELL * ni * nj * nk)
