"""The CPU twin of the residual-smoothing kernel's launch
(``ops/cuda_irs.py`` ``_launch``) for the tests: one axis's smoothing
computed line by line at the addresses the kernel computes from
``cuda_irs.line_plan`` alone (line L starts at ((L // inner) n inner +
L % inner) nv, its cells ``inner`` nv apart), with the kernel's forward and
backward sweeps. Imports no JAX."""

import torch

from adflow_torch.ops import cuda_irs


def twin_launch(src, dst, fac, axis):
    """A stand-in for ``cuda_irs._launch`` on the CPU, counting launches."""
    n, inner, n_lines = cuda_irs.line_plan(src.shape, axis)
    nv = src.shape[-1]
    line = torch.arange(n_lines)
    base = ((line // inner) * n * inner + line % inner) * nv
    idx = (base[:, None, None] + (torch.arange(n) * inner * nv)[None, :, None]
           + torch.arange(nv)[None, None, :])
    r = src.reshape(-1)[idx]
    g, den, cp = fac
    x = torch.empty_like(r)
    x[:, 0] = r[:, 0] / den[0]
    for m in range(1, n):
        x[:, m] = r[:, m] / den[m] - g[m] * x[:, m - 1]
    for m in range(n - 2, -1, -1):
        x[:, m] = x[:, m] - cp[m] * x[:, m + 1]
    flat = dst.view(-1)
    flat[idx.reshape(-1)] = x.reshape(-1)
    cuda_irs.LAUNCHES += 1
