"""K1, the fused RANS-SA residual kernel (``csrc/rans_residual.cu``): the
bytes and floating-point operations one launch needs on a block of
ni x nj x nk cells, counted from the operands the wrapper
``fused_rans_residual`` passes. Each input byte counts once and the
output once; f32 throughout. The operations are the arithmetic of the
plain version: per one-ring extended cell (derived state, sensor, three
radii and their scaling, 15 Green-Gauss gradient components), per face
(central flux, JST dissipation, the normal-corrected face gradient of 5
fields, stress tensor, heat flux, SA advection and diffusion) and per
interior cell (SA source, face differences); a transcendental counts 1."""

ITEMSIZE = 4
FLOP_PER_EXT_CELL = 400
FLOP_PER_FACE = 300
FLOP_PER_CELL = 160


def operand_shapes(ni, nj, nk):
    return {
        "w6": (ni + 4, nj + 4, nk + 4, 6),
        "siE": (ni + 3, nj + 2, nk + 2, 3),
        "sjE": (ni + 2, nj + 3, nk + 2, 3),
        "skE": (ni + 2, nj + 2, nk + 3, 3),
        "vol": (ni + 4, nj + 4, nk + 4),
        "xc": (ni + 2, nj + 2, nk + 2, 3),
        "dist": (ni + 2, nj + 2, nk + 2),
        "porI": (ni + 1, nj, nk),
        "porJ": (ni, nj + 1, nk),
        "porK": (ni, nj, nk + 1),
        "out": (ni, nj, nk, 6),
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
