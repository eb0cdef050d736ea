"""The CPU twin of the BC pass kernel's launch (``ops/cuda_bc.py``
``_launch``) for the tests: one op's ghosts, or their tangent, computed by
the plain pass's ghost map at the cells and faces the kernel addresses from
``cuda_bc.op_geometry`` alone. Shared by ``test_torch_bc_kernel.py`` and
``test_torch_trace.py``; imports no JAX."""

import torch

from adflow_torch.ops import cuda_bc
from adflow_torch.physics import bc


def twin_forward(w, s, op, winf, ref):
    """One op's ghosts written into ``w`` as the kernel addresses them:
    from ``op_geometry`` alone, the plain pass's ghost map."""
    g = cuda_bc.op_geometry(op)
    e1 = torch.clamp(torch.arange(g.lo1, g.lo1 + g.n1) - 2, g.a0, g.a1 - 1)
    e2 = torch.clamp(torch.arange(g.lo2, g.lo2 + g.n2) - 2, g.b0, g.b1 - 1)
    n = g.sign * s.select(g.axis, g.face)[e1][:, e2]
    nhat = n / torch.clamp(torch.linalg.norm(n, dim=-1, keepdim=True),
                           min=1e-30)
    cols = (slice(g.lo1, g.lo1 + g.n1), slice(g.lo2, g.lo2 + g.n2))
    for d in range(2):
        mirror = w.select(g.axis, g.mirror[d])[cols]
        w.select(g.axis, g.ghost[d])[cols] = bc._ghost_state(
            op, mirror, nhat, ref, winf)


def twin_launch(ref):
    """A stand-in for ``cuda_bc._launch`` on the CPU, counting launches."""
    def launch(w, dw, s, op, winf, dwinf=None):
        cuda_bc.LAUNCHES += 1
        if dw is None:
            twin_forward(w, s, op, winf, ref)
            return

        def one_op(w, winf):
            w = w.clone()
            twin_forward(w, s, op, winf, ref)
            return w
        wn, dwn = torch.func.jvp(one_op, (w, winf), (
            dw, torch.zeros_like(winf) if dwinf is None else dwinf))
        w.copy_(wn)
        dw.copy_(dwn)
    return launch
