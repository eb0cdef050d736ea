"""Implicit residual smoothing as one CUDA launch an axis of a block, and
the line factors both versions share.

Replaces no TPU kernel: the JAX package runs the smoothing as a Thomas
recurrence in ``lax.scan`` (``adflow_tpu/solvers/smoothers.py``). The CUDA
source is ``adflow_torch/csrc/residual_averaging.cu``: one thread a grid
line of the axis, all its channels, the forward and the backward sweep
with the constant line factors. ``solvers/smoothers.py``
``residual_averaging`` takes it where its input is what the kernel
computes (``smoothers._irs_kernel_applies``, the one place that decides)
and runs its plain sweeps everywhere else.

Bound on the H100: device-memory bytes, r read and x written once a launch
(``benchmark/roofline/irs.py`` counts them): 50.3 MB, 15 us at 3.35 TB/s on
the 256x64x64 block with 6 channels. The sweeps are a recurrence along
the line, so a launch has as many threads as the block has lines of the
axis (4,096 along i of that block): latency, not bytes, is what holds it.

The factors (g, denom, cp) of the constant tridiagonal system of a line of
length n are computed once on the host in float64 and kept on the device
(``line_factors``, one tensor per n, eps, dtype and device), so no call
copies from the host.
"""

from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch

from adflow_torch.ops import _nvcc

# kernel launches made through ``_launch`` (one an axis of a smoothing)
LAUNCHES = 0

SRC = _nvcc.CSRC / "residual_averaging.cu"
THREADS = 128          # residual_averaging.cu THREADS
NV = (5, 6, 7)         # channel counts it is instantiated for


def averaging_factors(n: int, eps: float):
    """The forward-elimination factors (g, denom, cp) of the constant
    tridiagonal (-eps, 1 + 2 eps, -eps) of length n, its end rows
    (1 + eps) and no coupling past the ends, as ``dadi.tridiag_factor``
    computes them: host (numpy, float64) work, since the coefficients are
    the same for every line."""
    lo = np.full(n, -eps)
    up = np.full(n, -eps)
    dg = np.full(n, 1.0 + 2.0 * eps)
    lo[0] = up[-1] = 0.0
    dg[0] = dg[-1] = 1.0 + eps
    g, den, cp = np.empty(n), np.empty(n), np.empty(n)
    cp_prev = 0.0
    for c in range(n):
        den[c] = dg[c] - lo[c] * cp_prev
        g[c] = lo[c] / den[c]
        cp[c] = cp_prev = up[c] / den[c]
    return g, den, cp


@functools.lru_cache(maxsize=64)
def line_factors(n: int, eps: float, dtype, device) -> torch.Tensor:
    """(3, n): ``averaging_factors(n, eps)`` rounded to ``dtype`` on
    ``device``, made once (a blocking copy from the host) and kept. Read
    only. Made as a plain tensor even where the first call comes inside a
    ``torch.func`` transform or inference mode, which would otherwise wrap
    what is kept for every later call."""
    with torch._C._DisableFuncTorch(), torch.inference_mode(False):
        return torch.as_tensor(np.stack(averaging_factors(n, eps)),
                               dtype=dtype, device=device)


@functools.lru_cache(maxsize=1)
def _lib():
    lib = ctypes.CDLL(str(_nvcc.build(SRC)))
    fn = lib.irs_axis_launch
    fn.restype = ctypes.c_int
    # in, out, fac; n, inner, n_lines, nv, threads; stream
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 5
                   + [ctypes.c_void_p])
    return lib


def line_plan(shape, axis: int):
    """(n, inner, n_lines) of the smoothing of a (n0, n1, n2, nv) block
    along ``axis``: the line length, the product of the dims after the axis
    (line L starts at ((L // inner) n inner + L % inner) nv) and the number
    of lines."""
    n = int(shape[axis])
    inner = math.prod(int(d) for d in shape[axis + 1:3])
    return n, inner, math.prod(int(d) for d in shape[:3]) // n


def check_operands(src, dst, fac, axis: int):
    """Raise ValueError unless ``src`` and ``dst`` are distinct contiguous
    float32 (n0, n1, n2, nv) blocks of one shape with nv in ``NV`` and
    ``fac`` the contiguous (3, n) float32 factors of the axis, all on one
    device."""
    if src.dim() != 4 or src.shape[-1] not in NV:
        raise ValueError(f"src: shape {tuple(src.shape)}, expected "
                         f"(n0, n1, n2, nv) with nv in {NV}")
    n = src.shape[axis]
    for name, t, shape in (("src", src, tuple(src.shape)),
                           ("dst", dst, tuple(src.shape)),
                           ("fac", fac, (3, n))):
        if t.device != src.device:
            raise ValueError(f"{name}: on {t.device}, expected {src.device}")
        if t.dtype != torch.float32:
            raise ValueError(f"{name}: dtype {t.dtype}, the kernel takes "
                             f"float32")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                             f"{shape}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: not contiguous")
    if src.data_ptr() == dst.data_ptr():
        raise ValueError("dst: the kernel writes a block distinct from src")


def _launch(src, dst, fac, axis: int):
    """Smooth ``src`` along ``axis`` into ``dst`` with the factors
    ``fac``: one launch."""
    global LAUNCHES
    if not src.is_cuda:
        raise ValueError(f"src: on {src.device}, the kernel runs on CUDA")
    check_operands(src, dst, fac, axis)
    n, inner, n_lines = line_plan(src.shape, axis)
    with torch.cuda.device(src.device):
        stream = torch.cuda.current_stream(src.device).cuda_stream
        err = _lib().irs_axis_launch(
            src.data_ptr(), dst.data_ptr(), fac.data_ptr(), n, inner,
            n_lines, src.shape[-1], THREADS, stream)
    if err != 0:
        raise RuntimeError(f"irs_axis_launch failed: CUDA error {err}")
    LAUNCHES += 1


def smooth(r, eps: float):
    """``r`` (n0, n1, n2, nv) smoothed along each axis of at least 3 cells
    in turn, one launch an axis, each into a new block; ``r`` itself where
    no axis has 3."""
    x = r.contiguous()
    for axis in range(3):
        if x.shape[axis] < 3:
            continue
        out = torch.empty_like(x)
        _launch(x, out, line_factors(int(x.shape[axis]), float(eps),
                                     x.dtype, x.device), axis)
        x = out
    return x


def irs_reference(r, eps: float):
    """The plain version: ``solvers/smoothers.py``
    ``plain_residual_averaging``."""
    from adflow_torch.solvers.smoothers import plain_residual_averaging
    return plain_residual_averaging(r, eps)
