"""Matrix-free restarted GMRES (counterpart of adflow_tpu/solvers/
krylov.py; reference: the PETSc KSP GMRES of NKSolvers.F90).

- Right preconditioning (solve A M^-1 u = b, x = M^-1 u), so the monitored
  residual is the true residual.
- Classical Gram-Schmidt with one re-orthogonalization pass (CGS2): two
  products with the basis per pass, against the rows filled so far.
- The JAX package's ``while_loop``s become Python loops. The small
  Hessenberg problem (Givens rotations, triangular solve) lives on the host
  in float64: each Arnoldi step copies its new column to the host once, and
  that copy carries |g[k]|, the residual estimate the loop tests. The
  vectors stay on the device in the working dtype.
- The loop stops on a non-finite g[k] too: an overflowed or NaN Arnoldi
  state would otherwise run to k = m with zero rotations and report an
  exactly-0.0 residual.
- ``group`` (the JAX package's ``axis_name``): the vectors are rank-local
  pieces of one global vector, and every dot product and norm is completed
  by an ``all_reduce`` over the process group before it reaches the host
  Hessenberg problem, so every rank takes the same decisions.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from adflow_torch.utils import trace


class GmresResult(NamedTuple):
    x: torch.Tensor
    res_norm: float     # estimated final residual norm
    b_norm: float
    iters: int          # total inner iterations
    converged: bool
    matvecs: int        # calls of matvec: one per cycle (b - A x) + iters


def _identity(v):
    return v


def _back_substitute(H, g, k):
    """y with H[:k, :k] y = g[:k], H upper triangular (host, float64)."""
    y = np.zeros(k)
    for i in range(k - 1, -1, -1):
        y[i] = (g[i] - np.dot(H[i, i + 1:k], y[i + 1:k])) / H[i, i]
    return y


@trace.spanned("krylov.gmres")
def gmres(matvec: Callable, b: torch.Tensor,
          x0: Optional[torch.Tensor] = None, m: int = 30, restarts: int = 1,
          tol: float = 1e-2, atol: float = 0.0,
          precond: Optional[Callable] = None, group=None) -> GmresResult:
    """Solve A x = b with restarted GMRES(m).

    matvec: v -> A v on flat vectors; precond: v -> M^-1 v (right PC).
    tol is relative to ||b||. ``group``: a ``torch.distributed`` process
    group over whose ranks the vectors are split, or None.
    """
    from adflow_torch.dist.comm import all_sum, global_norm

    Minv = precond or _identity
    n = b.shape[0]
    x = torch.zeros_like(b) if x0 is None else x0
    b_norm = float(global_norm(b, group))
    trace.host_sync()
    target = max(tol * b_norm, atol)
    V = torch.empty((m + 1, n), dtype=b.dtype, device=b.device)

    res, total, cycles = math.inf, 0, 0
    while res > target and total < m * restarts:
        with trace.span("krylov.matvec"):
            r0 = b - matvec(x)
        beta = global_norm(r0, group)
        V[0] = r0 / torch.clamp(beta, min=1e-30)
        H = np.zeros((m + 1, m))
        cs = np.zeros(m)
        sn = np.zeros(m)
        g = np.zeros(m + 1)
        g[0] = float(beta)
        trace.host_sync()
        k = 0
        while k < m and abs(g[k]) > target and math.isfinite(g[k]):
            with trace.span("krylov.iter"):
                with trace.span("krylov.precond"):
                    z = Minv(V[k])
                with trace.span("krylov.matvec"):
                    w = matvec(z)
                Vk = V[:k + 1]
                h1 = all_sum(Vk @ w, group)
                w = w - Vk.T @ h1
                h2 = all_sum(Vk @ w, group)
                w = w - Vk.T @ h2
                hk1 = global_norm(w, group)
                V[k + 1] = w / torch.clamp(hk1, min=1e-30)
                col = np.zeros(m + 1)
                col[:k + 2] = torch.cat(
                    [h1 + h2, hk1[None]]).double().cpu().numpy()
                trace.host_sync()
                # apply the stored Givens rotations to the new column
                for i in range(k):
                    ci, si = cs[i], sn[i]
                    col[i], col[i + 1] = (ci * col[i] + si * col[i + 1],
                                          -si * col[i] + ci * col[i + 1])
                # new rotation zeroing col[k+1]
                denom = math.sqrt(col[k] * col[k] + col[k + 1] * col[k + 1])
                ck = col[k] / max(denom, 1e-30) if denom > 0 else 1.0
                sk = col[k + 1] / max(denom, 1e-30) if denom > 0 else 0.0
                col[k], col[k + 1] = denom, 0.0
                g[k + 1] = -sk * g[k]
                g[k] = ck * g[k]
                H[:, k] = col
                cs[k], sn[k] = ck, sk
                k += 1
        if k > 0:
            y = torch.as_tensor(_back_substitute(H, g, k), dtype=b.dtype,
                                device=b.device)
            with trace.span("krylov.precond"):
                x = x + Minv(V[:k].T @ y)
        res = abs(g[k])
        total += k
        cycles += 1
    return GmresResult(x=x, res_norm=res, b_norm=b_norm, iters=total,
                       converged=res <= target, matvecs=cycles + total)
