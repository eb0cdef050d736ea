"""Central + JST inviscid residual kernel (K2) on Hopper, and its plain
version.

Replaces the TPU kernel ``adflow_tpu/ops/pallas_residual.py::_kernel``
(entry ``fused_inviscid_residual``, pallas_call at :225). The CUDA source is
``adflow_torch/csrc/inviscid_residual.cu``: one launch of one kernel, one
pass, no scratch in device memory, on the design of K1
(``csrc/rans_residual.cu``). Each thread block owns a j-k tile of 8 x 16
interior columns and marches along i over a segment of ``SI`` planes, two
threads a column: each padded plane of ``w5`` and ``p`` lands by
``cp.async`` one plane ahead and is converted once, by each column's second
thread, into a ring of five planes of primitive cells in shared memory; the
sensor and the three scaled radii of the current and the next extended
plane sit in shared memory; each j- and k-face is computed once into shared
memory, each i-face once by the column's first thread, which keeps it in
shared memory as the next plane's lower face (in registers it would pass
the 64-register cap of four blocks an SM). ``k2_tile_plan`` computes the segment, the grid, the shared bytes
and the copy width, so that the CPU tests check what the CUDA code relies
on.

Bound on the H100: device-memory bytes. One evaluation at 256x64x64 must
read its inputs once and write its output once, about 104 MB (31 us at
3.35 TB/s), against about 0.44 GFLOP (6.5 us at 67 TFLOP/s f32). No tensor
core applies: the kernel is a stencil with no matrix product.
``chip_smoke.py`` and ``python -m adflow_torch.ops.k2_timing`` measure it
against the bound.

On CPU tensors the wrapper computes the plain version
(``inviscid_residual_reference``). On CUDA tensors it launches the kernel or
raises; it never falls back. Derivatives (``torch.autograd`` backward and
forward-mode jvp) run through the plain version, like the JAX package's
``custom_jvp`` (pallas_residual.py:302-319).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from adflow_torch.ops import _nvcc

# kernel launches made through ``fused_inviscid_residual`` (one per call on
# CUDA)
LAUNCHES = 0

SRC = _nvcc.CSRC / "inviscid_residual.cu"

# Operation count per evaluation (flop_count), from the arithmetic of the
# plain version: per one-ring extended cell (velocity, sound speed, sensor
# in three directions, three radii and their directional scaling), per face
# (central flux and JST dissipation of five channels) and per interior cell
# (face differences). Transcendentals count 1.
FLOP_PER_EXT_CELL = 90
FLOP_PER_FACE = 95
FLOP_PER_CELL = 30

# The tile inviscid_residual.cu is built for: TJ x TK columns,
# K2_THREADS_PER_COLUMN threads a column, K2_BLOCKS_PER_SM blocks on an SM
# (its __launch_bounds__).
K2_TILE = (8, 16)
K2_THREADS_PER_COLUMN = 2
K2_BLOCKS_PER_SM = 4
# shared memory of one block, in floats: one raw plane of w5 and p (6 floats
# a cell), CELL_PLANES planes of N_CELL floats a cell (the four a step reads
# and the one the next step's plane lands in), two planes of N_DERIVED
# derived fields, N_FACE floats per j-, k- and i-face of a plane
CELL_PLANES, N_CELL, N_DERIVED, N_FACE = 5, 6, 4, 5


class K2Plan(NamedTuple):
    """How one launch covers a block: ``tj x tk`` columns per thread block,
    ``si`` planes per segment; grid (k tiles, j tiles, segments)."""
    tj: int
    tk: int
    si: int
    grid: tuple
    threads: int
    smem_bytes: int
    copy_width: int


def k2_tile_plan(ni, nj, nk, si=None, n_sm=_nvcc.N_SM):
    """The launch plan of K2 for a block of ``ni x nj x nk`` interior cells
    on a card with ``n_sm`` SMs.

    Thread block (x, y, z) owns interior columns j in [y tj, y tj + tj) and
    k in [x tk, x tk + tk) of the segment i in [z si, z si + si), each range
    cut at the block's edge. Without ``si``, the segment fills whole waves
    of resident blocks (``_nvcc.segment``). Rows of the padded ``w5`` and
    ``p`` planes are copied 16 bytes at a time when every row the kernel
    copies starts 16-byte aligned and lies inside the block (from aligned
    base pointers), else 4 bytes: a row starts at cell ``(I (nj+4) + J)
    (nk+4) + k0``, 20 bytes a cell of ``w5`` and 4 of ``p``, so that needs
    ``nk + 4`` a multiple of 4 (k0 is a multiple of ``tk``, itself one of 4)
    and no ragged k tile. The kernel's offsets are 32-bit: its launch
    refuses a block whose ``w5`` holds 2^31 floats or more."""
    tj, tk = K2_TILE
    grid = (-(-nk // tk), -(-nj // tj))
    if si is None:
        si = _nvcc.segment(ni, grid[0] * grid[1], n_sm * K2_BLOCKS_PER_SM)
    if si < 1:
        raise ValueError(f"segment of {si} planes")
    ring_cells = (tj + 4) * (tk + 4)
    floats = (ring_cells * 6 + CELL_PLANES * N_CELL * ring_cells
              + 2 * N_DERIVED * (tj + 2) * (tk + 2)
              + N_FACE * ((tj + 1) * tk + tj * (tk + 1) + tj * tk))
    wide = (nk + 4) % 4 == 0 and nk % tk == 0
    return K2Plan(tj, tk, si, (*grid, -(-ni // si)),
                  K2_THREADS_PER_COLUMN * tj * tk, 4 * floats,
                  16 if wide else 4)


@functools.lru_cache(maxsize=1)
def _lib():
    lib = ctypes.CDLL(str(_nvcc.build(SRC)))
    fn = lib.inviscid_residual_launch
    fn.restype = ctypes.c_int
    # w5, p, siE, sjE, skE, porI, porJ, porK, out; ni, nj, nk, tj, tk,
    # threads, si, copy_width, smem_bytes; vis2, vis4, expo; stream
    fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 9
                   + [ctypes.c_float] * 3 + [ctypes.c_void_p])
    return lib


def _expected_shapes(ni, nj, nk):
    return {
        "w5": (ni + 4, nj + 4, nk + 4, 5),
        "p": (ni + 4, nj + 4, nk + 4),
        "siE": (ni + 3, nj + 2, nk + 2, 3),
        "sjE": (ni + 2, nj + 3, nk + 2, 3),
        "skE": (ni + 2, nj + 2, nk + 3, 3),
        "porI": (ni + 1, nj, nk),
        "porJ": (ni, nj + 1, nk),
        "porK": (ni, nj, nk + 1),
    }


def check_operands(tensors):
    """Raise ValueError unless the eight operands are contiguous float32
    tensors on ``w5``'s device with the shapes ``w5`` implies; returns
    (ni, nj, nk)."""
    w5 = tensors[0]
    if w5.dim() != 4 or w5.shape[-1] != 5:
        raise ValueError(f"w5: shape {tuple(w5.shape)}, expected "
                         f"(ni+4, nj+4, nk+4, 5)")
    ni, nj, nk = (s - 4 for s in w5.shape[:3])
    for (name, shape), t in zip(_expected_shapes(ni, nj, nk).items(),
                                tensors):
        if t.device != w5.device:
            raise ValueError(f"{name}: on {t.device}, expected {w5.device}")
        if t.dtype != torch.float32:
            raise ValueError(f"{name}: dtype {t.dtype}, the kernel takes "
                             f"float32")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                             f"{shape}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: not contiguous")
    return ni, nj, nk


def _launch(tensors, vis2, vis4, expo, plan=None):
    """Check the operands and launch the kernel with ``plan`` (default
    ``k2_tile_plan``); returns (ni, nj, nk, 5)."""
    global LAUNCHES
    w5, p = tensors[:2]
    if not w5.is_cuda:
        raise ValueError(f"w5: on {w5.device}, the kernel runs on CUDA")
    ni, nj, nk = check_operands(tensors)
    plan = plan or k2_tile_plan(ni, nj, nk, n_sm=_nvcc.n_sm(w5.device))
    # the plan's 16-byte copies assume aligned bases
    aligned = w5.data_ptr() % 16 == 0 and p.data_ptr() % 16 == 0
    width = plan.copy_width if aligned else 4
    lib = _lib()
    with torch.cuda.device(w5.device):
        out = torch.empty((ni, nj, nk, 5), dtype=torch.float32,
                          device=w5.device)
        stream = torch.cuda.current_stream(w5.device).cuda_stream
        err = lib.inviscid_residual_launch(
            *(t.data_ptr() for t in tensors), out.data_ptr(), ni, nj, nk,
            plan.tj, plan.tk, plan.threads, plan.si, width, plan.smem_bytes,
            float(vis2), float(vis4), float(expo), stream)
    if err != 0:
        raise RuntimeError(f"inviscid_residual_launch failed: CUDA error "
                           f"{err}")
    LAUNCHES += 1
    return out


def inviscid_residual_reference(w5, p, siE, sjE, skE, porI, porJ, porK,
                                vis2, vis4, expo):
    """The plain PyTorch version: ``physics/fluxes.inviscid_residual``
    (counterpart of pallas_residual.py:292 _jnp_reference). No in-place
    writes, so torch.func transforms apply."""
    from adflow_torch.geom.metrics import BlockMetrics
    from adflow_torch.physics.fluxes import inviscid_residual

    m = BlockMetrics(siE=siE, sjE=sjE, skE=skE, vol=None, xc_ext=None)
    return inviscid_residual(w5, p, m, vis2, vis4, expo,
                             por=(porI, porJ, porK))


class _FusedInviscid(torch.autograd.Function):
    """Kernel forward; backward and jvp through the plain version."""

    @staticmethod
    def forward(*args):
        return _launch(args[:8], *args[8])

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.consts = inputs[8]
        ctx.save_for_backward(*inputs[:8])
        ctx.save_for_forward(*inputs[:8])

    @staticmethod
    def backward(ctx, grad_out):
        prim = ctx.saved_tensors
        _, vjp = torch.func.vjp(
            lambda *a: inviscid_residual_reference(*a, *ctx.consts), *prim)
        return (*vjp(grad_out), None)

    @staticmethod
    def jvp(ctx, *tangents):
        prim = ctx.saved_tensors
        tang = tuple(torch.zeros_like(p) if t is None else t
                     for p, t in zip(prim, tangents[:8]))
        _, out = torch.func.jvp(
            lambda *a: inviscid_residual_reference(*a, *ctx.consts), prim,
            tang)
        return out


def fused_inviscid_residual(w5, p, siE, sjE, skE, porI, porJ, porK, vis2,
                            vis4, expo):
    """The five mean-flow residual channels of one halo-filled block,
    (ni, nj, nk, 5). Same signature and output as the JAX package's
    ``fused_inviscid_residual`` (pallas_residual.py:303)."""
    consts = (float(vis2), float(vis4), float(expo))
    tensors = (w5, p, siE, sjE, skE, porI, porJ, porK)
    if w5.is_cuda:
        return _FusedInviscid.apply(*tensors, consts)
    if any(t.is_cuda for t in tensors):
        raise ValueError("fused_inviscid_residual: operands on mixed devices")
    return inviscid_residual_reference(*tensors, *consts)


def sample_operands(dims, device, seed=3, amp=0.01, mach=0.5, alpha=2.0):
    """Operands and constants of one evaluation on a ``wing_omesh`` Euler
    block with ``dims`` interior cells: float32 metrics and porosities on
    ``device``, and the free stream at ``mach``, ``alpha`` perturbed by
    ``amp`` relative noise from ``seed`` with its halos filled (the setup of
    the JAX package's tests/test_pallas.py), for checks and timing."""
    import numpy as np

    from adflow_torch.core.refstate import AeroProblem, make_reference_state
    from adflow_torch.geom.metrics import compute_metrics
    from adflow_torch.meshgen.analytic import wing_omesh
    from adflow_torch.physics.residual import build_topology, fill_halos
    from adflow_torch.physics.thermo import pressure

    f32 = torch.float32
    mesh = wing_omesh(ni=dims[0], nj=dims[1], nk=dims[2], viscous=False)
    ref = make_reference_state(AeroProblem(name="p", mach=mach, alpha=alpha),
                               lift_index=2, n_turb=0)
    winf = torch.as_tensor(ref.winf(), dtype=f32, device=device)
    topo = build_topology(mesh, dtype=f32, device=device)
    m = compute_metrics(torch.as_tensor(mesh.blocks[0].x, dtype=f32,
                                        device=device))
    rng = np.random.default_rng(seed)
    w = np.broadcast_to(np.asarray(ref.winf(), np.float32),
                        tuple(n + 4 for n in dims) + (5,)).copy()
    w *= 1.0 + amp * rng.standard_normal(w.shape)
    (wf,) = fill_halos([torch.as_tensor(w, dtype=f32, device=device)], [m],
                       topo, ref, winf)
    tensors = [wf.contiguous(), pressure(wf).contiguous(), m.siE, m.sjE,
               m.skE, *topo.blocks[0].por]
    return tensors, (0.25, 1.0 / 64.0, 0.67)


def min_bytes(ni, nj, nk, itemsize=4):
    """Bytes one evaluation must move: each input read once, the output
    written once."""
    n = sum(int(torch.Size(s).numel())
            for s in _expected_shapes(ni, nj, nk).values())
    return (n + ni * nj * nk * 5) * itemsize


def flop_count(ni, nj, nk):
    """Floating-point operations of one evaluation (see FLOP_PER_*)."""
    n_ext = (ni + 2) * (nj + 2) * (nk + 2)
    n_faces = (ni + 1) * nj * nk + ni * (nj + 1) * nk + ni * nj * (nk + 1)
    return (FLOP_PER_EXT_CELL * n_ext + FLOP_PER_FACE * n_faces
            + FLOP_PER_CELL * ni * nj * nk)
