"""Fused RANS-SA residual kernel (K1) on Hopper, and its plain version.

Replaces the TPU kernel ``adflow_tpu/ops/pallas_rans.py::_kernel`` (entry
``fused_rans_residual``, pallas_call at :512). The CUDA source is
``adflow_torch/csrc/rans_residual.cu``: one launch of one kernel, one pass,
no scratch in device memory. Each thread block owns a j-k tile of 8 x 16
interior columns, two threads a column, and marches along i over a segment
of ``SI`` planes: each padded plane of ``w`` lands by ``cp.async`` one plane
ahead and is converted once into a ring of four planes of primitive cells
in shared memory; the derived fields of the current and the next extended
plane sit in shared memory; each j- and k-face is computed once into shared
memory, each i-face once in registers and carried down the march.
``k1_tile_plan`` computes the segment, the grid, the shared bytes and the
copy width, so that the CPU tests check what the CUDA code relies on.

Bound on the H100: device-memory bytes. One evaluation at 256x64x64 must
read its inputs once and write its output once, about 130 MB (39 us at
3.35 TB/s), against about 1.6 GFLOP (23 us at 67 TFLOP/s f32). No tensor
core applies: the kernel is a stencil with no matrix product. The
benchmark's traced run measures it against the bound (``k1_roofline``,
``benchmark/roofline/k1.py``).

On CPU tensors the wrapper computes the plain version
(``rans_residual_reference``). On CUDA tensors it launches the kernel or
raises; it never falls back. Derivatives (``torch.autograd`` backward and
forward-mode jvp) run through the plain version, like the JAX package's
``custom_jvp`` (pallas_rans.py:633-657).
"""

from __future__ import annotations

import ctypes
import functools
import types
from typing import NamedTuple

import torch

from adflow_torch.ops import _nvcc

# kernel launches made through ``fused_rans_residual`` (one per call on CUDA)
LAUNCHES = 0

SRC = _nvcc.CSRC / "rans_residual.cu"


# The tile rans_residual.cu is built for: TJ x TK columns, two threads a
# column, K1_BLOCKS_PER_SM blocks on an SM (its __launch_bounds__).
K1_TILE = (8, 16)
K1_THREADS = 256
K1_BLOCKS_PER_SM = 2
# shared memory of one block, in floats: one raw plane of w, CELL_PLANES
# planes of N_CELL floats a cell, two planes of N_DERIVED derived fields,
# N_FACE floats per j- and k-face of a plane, one SA source a column
CELL_PLANES, N_CELL, N_DERIVED, N_FACE = 4, 11, 22, 12


class K1Plan(NamedTuple):
    """How one launch covers a block: ``tj x tk`` columns per thread block,
    ``si`` planes per segment; grid (k tiles, j tiles, segments)."""
    tj: int
    tk: int
    si: int
    grid: tuple
    threads: int
    smem_bytes: int
    copy_width: int


def k1_tile_plan(ni, nj, nk, si=None, n_sm=_nvcc.N_SM):
    """The launch plan of K1 for a block of ``ni x nj x nk`` interior cells
    on a card with ``n_sm`` SMs.

    Thread block (x, y, z) owns interior columns j in [y tj, y tj + tj) and
    k in [x tk, x tk + tk) of the segment i in [z si, z si + si), each range
    cut at the block's edge. Without ``si``, the segment fills whole waves
    of resident blocks (``_nvcc.segment``). Rows of the padded ``w`` plane are
    copied 16 bytes at a time when every row the kernel copies starts
    16-byte aligned and lies inside the block (from an aligned base
    pointer), else 4 bytes: a row starts at cell ``(I (nj+4) + J)(nk+4) +
    k0``, 24 bytes a cell, so that needs ``nk + 4`` even (k0 is a multiple of
    the even ``tk``) and no ragged k tile."""
    tj, tk = K1_TILE
    grid = (-(-nk // tk), -(-nj // tj))
    if si is None:
        si = _nvcc.segment(ni, grid[0] * grid[1], n_sm * K1_BLOCKS_PER_SM)
    if si < 1:
        raise ValueError(f"segment of {si} planes")
    ring_cells = (tj + 4) * (tk + 4)
    floats = (ring_cells * 6 + CELL_PLANES * N_CELL * ring_cells
              + 2 * N_DERIVED * (tj + 2) * (tk + 2)
              + N_FACE * ((tj + 1) * tk + tj * (tk + 1)) + tj * tk)
    wide = (nk + 4) % 2 == 0 and nk % tk == 0
    return K1Plan(tj, tk, si, (*grid, -(-ni // si)), K1_THREADS, 4 * floats,
                  16 if wide else 4)


@functools.lru_cache(maxsize=1)
def _lib():
    lib = ctypes.CDLL(str(_nvcc.build(SRC)))
    fn = lib.rans_residual_launch
    fn.restype = ctypes.c_int
    # w6 .. porK, out; ni, nj, nk, tj, tk, threads, si, copy_width,
    # smem_bytes; vis2, vis4, expo, mu_inf, s_suth; use_ft2, turb_scale,
    # coarse, stream
    fn.argtypes = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 9
                   + [ctypes.c_float] * 5
                   + [ctypes.c_int, ctypes.c_float, ctypes.c_int,
                      ctypes.c_void_p])
    return lib


def _expected_shapes(ni, nj, nk):
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
    }


def check_operands(tensors):
    """Raise ValueError unless the ten operands are contiguous float32
    tensors on ``w6``'s device with the shapes ``w6`` implies; returns
    (ni, nj, nk)."""
    w6 = tensors[0]
    if w6.dim() != 4:
        raise ValueError(f"w6: shape {tuple(w6.shape)}, expected "
                         f"(ni+4, nj+4, nk+4, 6)")
    ni, nj, nk = (s - 4 for s in w6.shape[:3])
    for (name, shape), t in zip(_expected_shapes(ni, nj, nk).items(),
                                tensors):
        if t.device != w6.device:
            raise ValueError(f"{name}: on {t.device}, expected {w6.device}")
        if t.dtype != torch.float32:
            raise ValueError(f"{name}: dtype {t.dtype}, the kernel takes "
                             f"float32")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                             f"{shape}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: not contiguous")
    return ni, nj, nk


def _launch(tensors, vis2, vis4, expo, mu_inf, t_inf_dim, use_ft2,
            turb_scale, coarse=False, plan=None):
    """Check the operands and launch the kernel with ``plan`` (default
    ``k1_tile_plan``), its coarse-level instantiation with ``coarse``;
    returns (ni, nj, nk, 6)."""
    global LAUNCHES
    w6 = tensors[0]
    if not w6.is_cuda:
        raise ValueError(f"w6: on {w6.device}, the kernel runs on CUDA")
    ni, nj, nk = check_operands(tensors)
    plan = plan or k1_tile_plan(ni, nj, nk, n_sm=_nvcc.n_sm(w6.device))
    # the plan's 16-byte copies assume an aligned base
    width = plan.copy_width if w6.data_ptr() % 16 == 0 else 4
    lib = _lib()
    with torch.cuda.device(w6.device):
        out = torch.empty((ni, nj, nk, 6), dtype=torch.float32,
                          device=w6.device)
        stream = torch.cuda.current_stream(w6.device).cuda_stream
        err = lib.rans_residual_launch(
            *(t.data_ptr() for t in tensors), out.data_ptr(), ni, nj, nk,
            plan.tj, plan.tk, plan.threads, plan.si, width,
            plan.smem_bytes, float(vis2),
            float(vis4), float(expo), float(mu_inf),
            float(_s_suth(t_inf_dim)), int(bool(use_ft2)), float(turb_scale),
            int(bool(coarse)), stream)
    if err != 0:
        raise RuntimeError(f"rans_residual_launch failed: CUDA error {err}")
    LAUNCHES += 1
    return out


def _s_suth(t_inf_dim):
    from adflow_torch.core.refstate import S_SUTH
    return S_SUTH / t_inf_dim


def rans_residual_reference(w6, siE, sjE, skE, vol, xc, dist, porI, porJ,
                            porK, vis2, vis4, expo, mu_inf, t_inf_dim,
                            use_ft2, turb_scale, coarse=False):
    """The plain PyTorch version: inviscid + viscous residual concatenated
    with the SA residual (counterpart of pallas_rans.py:605 _jnp_reference).
    ``coarse``: the multigrid coarse levels' dissipation (``const_diss``: a
    constant 2nd difference vis2, no sensor, no 4th difference). No
    in-place writes, so torch.func transforms apply."""
    from adflow_torch.geom.metrics import BlockMetrics
    from adflow_torch.physics.fluxes import inviscid_residual
    from adflow_torch.physics.residual import ProblemConfig
    from adflow_torch.physics.sa import sa_residual
    from adflow_torch.physics.thermo import pressure
    from adflow_torch.physics.viscous import viscous_residual

    ref = types.SimpleNamespace(mu_inf=mu_inf, t_inf_dim=t_inf_dim)
    m = BlockMetrics(siE=siE, sjE=sjE, skE=skE, vol=vol, xc_ext=xc)
    cfg = ProblemConfig(equation_type="rans", vis2=vis2, vis4=vis4,
                        diss_exponent=expo, turbulence_model="sa",
                        turb_res_scale=turb_scale, use_ft2=use_ft2)
    p = pressure(w6)
    r = inviscid_residual(w6, p, m, vis2, vis4, expo, por=(porI, porJ, porK),
                          const_diss=coarse)
    r = r + viscous_residual(w6, p, m, cfg, ref)
    rt = sa_residual(w6, p, m, cfg, ref, dist)
    return torch.cat([r, rt], dim=-1)


class _FusedRans(torch.autograd.Function):
    """Kernel forward; backward and jvp through the plain version.

    ``apply(*tensors, mu_inf, t_inf_dim, consts)``: the ten operands, the
    two flow constants, each a float or a 0-d tensor, and (vis2, vis4,
    expo, use_ft2, turb_scale, coarse). A flow constant given as a tensor is an
    input of its own, so that derivatives reach it (the adjoint makes both
    depend on the design variables); the launch reads its value, which is
    legal here since a forward sees its inputs unwrapped under
    ``torch.func``."""

    @staticmethod
    def forward(*args):
        vis2, vis4, expo, use_ft2, turb_scale, coarse = args[12]
        return _launch(args[:10], vis2, vis4, expo, float(args[10]),
                       float(args[11]), use_ft2, turb_scale, coarse)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.consts = inputs[12]
        # None where the input is a tensor, saved below in order
        ctx.args = tuple(None if torch.is_tensor(a) else a
                         for a in inputs[:12])
        saved = [a for a in inputs[:12] if torch.is_tensor(a)]
        ctx.save_for_backward(*saved)
        ctx.save_for_forward(*saved)

    @staticmethod
    def backward(ctx, grad_out):
        _, vjp = torch.func.vjp(_plain_of_saved(ctx), *ctx.saved_tensors)
        grads = iter(vjp(grad_out))
        return (*(next(grads) if a is None else None for a in ctx.args),
                None)

    @staticmethod
    def jvp(ctx, *tangents):
        prim = ctx.saved_tensors
        tang = [t for a, t in zip(ctx.args, tangents[:12]) if a is None]
        tang = tuple(torch.zeros_like(p) if t is None else t
                     for p, t in zip(prim, tang))
        _, out = torch.func.jvp(_plain_of_saved(ctx), prim, tang)
        return out


def _plain_of_saved(ctx):
    """The plain version as a function of the saved tensor inputs."""
    vis2, vis4, expo, use_ft2, turb_scale, coarse = ctx.consts

    def plain(*tensors):
        it = iter(tensors)
        a = [next(it) if v is None else v for v in ctx.args]
        return rans_residual_reference(*a[:10], vis2, vis4, expo, a[10],
                                       a[11], use_ft2, turb_scale, coarse)

    return plain


def fused_rans_residual(w6, siE, sjE, skE, vol, xc, dist, porI, porJ, porK,
                        vis2, vis4, expo, mu_inf, t_inf_dim, use_ft2,
                        turb_scale, coarse=False):
    """All six RANS-SA residual channels of one halo-filled block,
    (ni, nj, nk, 6). Same signature and output as the JAX package's
    ``fused_rans_residual`` (pallas_rans.py:635), plus ``coarse``: the
    multigrid coarse levels' scheme (constant 2nd-difference dissipation
    vis2, no sensor, no 4th difference). ``mu_inf`` and ``t_inf_dim`` may
    be 0-d tensors, and derivatives then reach them."""
    mu_inf, t_inf_dim = (a if torch.is_tensor(a) else float(a)
                         for a in (mu_inf, t_inf_dim))
    consts = (float(vis2), float(vis4), float(expo), bool(use_ft2),
              float(turb_scale), bool(coarse))
    tensors = (w6, siE, sjE, skE, vol, xc, dist, porI, porJ, porK)
    if w6.is_cuda:
        return _FusedRans.apply(*tensors, mu_inf, t_inf_dim, consts)
    if any(t.is_cuda for t in tensors):
        raise ValueError("fused_rans_residual: operands on mixed devices")
    return rans_residual_reference(*tensors, *consts[:3], mu_inf, t_inf_dim,
                                   *consts[3:])


def sample_operands(dims, device, seed=0, amp=0.03):
    """Operands and constants of one evaluation on a ``wing_omesh`` block
    with ``dims`` interior cells: float32 metrics, wall distance and
    porosities on ``device``, and the free stream at M 0.8, alpha 1.5,
    Re 1e6 perturbed by ``amp`` relative noise from ``seed`` (the setup of
    the JAX package's tests/test_pallas_rans.py), for the kernel's checks."""
    import numpy as np

    from adflow_torch.core.refstate import AeroProblem, make_reference_state
    from adflow_torch.geom.metrics import compute_metrics
    from adflow_torch.geom.walldist import compute_wall_distances
    from adflow_torch.meshgen.analytic import wing_omesh
    from adflow_torch.physics.residual import build_topology

    f32 = torch.float32
    mesh = wing_omesh(ni=dims[0], nj=dims[1], nk=dims[2], viscous=True)
    ref = make_reference_state(
        AeroProblem(name="w", mach=0.8, alpha=1.5, reynolds=1e6),
        lift_index=2, n_turb=1)
    x = torch.as_tensor(mesh.blocks[0].x, dtype=f32, device=device)
    m = compute_metrics(x)
    d = compute_wall_distances(mesh, [x])[0]
    por = build_topology(mesh, dtype=f32, device=device).blocks[0].por
    rng = np.random.RandomState(seed)
    shp = tuple(n + 4 for n in dims) + (6,)
    w = np.broadcast_to(np.asarray(ref.winf(), np.float32), shp).copy()
    w *= 1.0 + amp * rng.randn(*shp).astype(np.float32)
    w[..., 5] = np.abs(w[..., 5])
    tensors = [torch.as_tensor(w, device=device), m.siE, m.sjE, m.skE,
               m.vol, m.xc_ext, d, *por]
    consts = (0.25, 1.0 / 64.0, 0.67, ref.mu_inf, ref.t_inf_dim, True, 1e4)
    return tensors, consts
