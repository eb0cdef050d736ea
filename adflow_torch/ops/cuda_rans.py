"""Fused RANS-SA residual kernel (K1) on Hopper, and its plain version.

Replaces the TPU kernel ``adflow_tpu/ops/pallas_rans.py::_kernel`` (entry
``fused_rans_residual``, pallas_call at :512). The CUDA source is
``adflow_torch/csrc/rans_residual.cu``: pass 1 writes 27 derived fields per
one-ring extended cell to a scratch buffer, pass 2 computes each interior
cell's six face fluxes and its SA source and writes all six channels.

Bound on the H100: device-memory bytes. One evaluation at 256x64x64 must
read its inputs once and write its output once, about 130 MB (39 us at
3.35 TB/s), against about 1.6 GFLOP (23 us at 67 TFLOP/s f32). This first
version is the simple, deterministic design (no atomics, no shared-memory
tiles); it moves the scratch round trip and neighbour re-reads on top of
the bound. ``chip_smoke.py`` measures it against the bound.

On CPU tensors the wrapper computes the plain version
(``rans_residual_reference``). On CUDA tensors it launches the kernel or
raises; it never falls back. Derivatives (``torch.autograd`` backward and
forward-mode jvp) run through the plain version, like the JAX package's
``custom_jvp`` (pallas_rans.py:633-657).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import types
from pathlib import Path

import torch

# kernel launches made through ``fused_rans_residual`` (one per call on CUDA)
LAUNCHES = 0

_SRC = Path(__file__).resolve().parents[1] / "csrc" / "rans_residual.cu"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "adflow_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

# Operation count per evaluation (flop_count), from the arithmetic of the
# plain version: per one-ring extended cell (derived state, sensor, three
# radii and their scaling, 15 Green-Gauss gradient components), per face
# (central flux, JST dissipation, normal-corrected face gradient of 5
# fields, stress tensor, heat flux, SA advection and diffusion) and per
# interior cell (SA source, face differences). Transcendentals count 1.
FLOP_PER_EXT_CELL = 400
FLOP_PER_FACE = 300
FLOP_PER_CELL = 160


def nvcc_path() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built with the "
                       "CUDA toolkit on the machine that has the card")


def library_path() -> Path:
    """Where the shared library for the current source and flags goes."""
    h = hashlib.sha256(_SRC.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"librans_residual_{h.hexdigest()[:16]}.so"


def build_command(out: Path):
    return [nvcc_path(), *NVCC_FLAGS, "-o", str(out), str(_SRC)]


def build() -> Path:
    """Compile the kernel if this source has no library yet; return it."""
    out = library_path()
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        subprocess.run(build_command(tmp), check=True)
        os.replace(tmp, out)
    return out


@functools.lru_cache(maxsize=1)
def _lib():
    lib = ctypes.CDLL(str(build()))
    fn = lib.rans_residual_launch
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 12 + [ctypes.c_int] * 3
                   + [ctypes.c_float] * 5 + [ctypes.c_int, ctypes.c_float,
                                             ctypes.c_void_p])
    lib.rans_residual_scratch_fields.restype = ctypes.c_int
    lib.rans_residual_scratch_fields.argtypes = []
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
            turb_scale):
    """Check the operands and launch the kernel; returns (ni, nj, nk, 6)."""
    global LAUNCHES
    w6 = tensors[0]
    if not w6.is_cuda:
        raise ValueError(f"w6: on {w6.device}, the kernel runs on CUDA")
    ni, nj, nk = check_operands(tensors)
    lib = _lib()
    n_ext = (ni + 2) * (nj + 2) * (nk + 2)
    with torch.cuda.device(w6.device):
        scratch = torch.empty(lib.rans_residual_scratch_fields() * n_ext,
                              dtype=torch.float32, device=w6.device)
        out = torch.empty((ni, nj, nk, 6), dtype=torch.float32,
                          device=w6.device)
        stream = torch.cuda.current_stream(w6.device).cuda_stream
        err = lib.rans_residual_launch(
            *(t.data_ptr() for t in tensors), scratch.data_ptr(),
            out.data_ptr(), ni, nj, nk, float(vis2), float(vis4), float(expo),
            float(mu_inf), float(_s_suth(t_inf_dim)), int(bool(use_ft2)),
            float(turb_scale), stream)
    if err != 0:
        raise RuntimeError(f"rans_residual_launch failed: CUDA error {err}")
    LAUNCHES += 1
    return out


def _s_suth(t_inf_dim):
    from adflow_torch.core.refstate import S_SUTH
    return S_SUTH / t_inf_dim


def rans_residual_reference(w6, siE, sjE, skE, vol, xc, dist, porI, porJ,
                            porK, vis2, vis4, expo, mu_inf, t_inf_dim,
                            use_ft2, turb_scale):
    """The plain PyTorch version: inviscid + viscous residual concatenated
    with the SA residual (counterpart of pallas_rans.py:605 _jnp_reference).
    No in-place writes, so torch.func transforms apply."""
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
    r = inviscid_residual(w6, p, m, vis2, vis4, expo, por=(porI, porJ, porK))
    r = r + viscous_residual(w6, p, m, cfg, ref)
    rt = sa_residual(w6, p, m, cfg, ref, dist)
    return torch.cat([r, rt], dim=-1)


class _FusedRans(torch.autograd.Function):
    """Kernel forward; backward and jvp through the plain version."""

    @staticmethod
    def forward(*args):
        return _launch(args[:10], *args[10])

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.consts = inputs[10]
        ctx.save_for_backward(*inputs[:10])
        ctx.save_for_forward(*inputs[:10])

    @staticmethod
    def backward(ctx, grad_out):
        prim = ctx.saved_tensors
        _, vjp = torch.func.vjp(
            lambda *a: rans_residual_reference(*a, *ctx.consts), *prim)
        return (*vjp(grad_out), None)

    @staticmethod
    def jvp(ctx, *tangents):
        prim = ctx.saved_tensors
        tang = tuple(torch.zeros_like(p) if t is None else t
                     for p, t in zip(prim, tangents[:10]))
        _, out = torch.func.jvp(
            lambda *a: rans_residual_reference(*a, *ctx.consts), prim, tang)
        return out


def fused_rans_residual(w6, siE, sjE, skE, vol, xc, dist, porI, porJ, porK,
                        vis2, vis4, expo, mu_inf, t_inf_dim, use_ft2,
                        turb_scale):
    """All six RANS-SA residual channels of one halo-filled block,
    (ni, nj, nk, 6). Same signature and output as the JAX package's
    ``fused_rans_residual`` (pallas_rans.py:635)."""
    consts = (float(vis2), float(vis4), float(expo), float(mu_inf),
              float(t_inf_dim), bool(use_ft2), float(turb_scale))
    tensors = (w6, siE, sjE, skE, vol, xc, dist, porI, porJ, porK)
    if w6.is_cuda:
        return _FusedRans.apply(*tensors, consts)
    if any(t.is_cuda for t in tensors):
        raise ValueError("fused_rans_residual: operands on mixed devices")
    return rans_residual_reference(*tensors, *consts)


def sample_operands(dims, device, seed=0, amp=0.03):
    """Operands and constants of one evaluation on a ``wing_omesh`` block
    with ``dims`` interior cells: float32 metrics, wall distance and
    porosities on ``device``, and the free stream at M 0.8, alpha 1.5,
    Re 1e6 perturbed by ``amp`` relative noise from ``seed`` (the setup of
    the JAX package's tests/test_pallas_rans.py), for checks and timing."""
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


def min_bytes(ni, nj, nk, itemsize=4):
    """Bytes one evaluation must move: each input read once, the output
    written once."""
    n = sum(int(torch.Size(s).numel())
            for s in _expected_shapes(ni, nj, nk).values())
    return (n + ni * nj * nk * 6) * itemsize


def flop_count(ni, nj, nk):
    """Floating-point operations of one evaluation (see FLOP_PER_*)."""
    n_ext = (ni + 2) * (nj + 2) * (nk + 2)
    n_faces = (ni + 1) * nj * nk + ni * (nj + 1) * nk + ni * nj * (nk + 1)
    return (FLOP_PER_EXT_CELL * n_ext + FLOP_PER_FACE * n_faces
            + FLOP_PER_CELL * ni * nj * nk)
