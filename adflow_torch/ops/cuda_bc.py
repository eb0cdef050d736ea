"""The physical-BC pass of one block as one CUDA launch a subface, with its
tangent, and its plain version.

Replaces no TPU kernel: the JAX package's BCs are plain ``jnp``
(``adflow_tpu/physics/bc.py``). The CUDA source is
``adflow_torch/csrc/bc_ghost.cu``: one launch a subface (``BCOp``), one
thread a tangential cell of its extended extent, both ghost layers and all
channels; the same templated source computes the tangent. ``KINDS`` lists
the BC kinds it computes; ``physics/bc.py`` ``apply_bcs`` takes this pass
where its input is what the kernel computes (``bc._kernel_applies``, the
one place that decides), and the plain pass (``bc_pass_reference``, a call
of ``bc.plain_bc_pass``) everywhere else.

Bound on the H100: device-memory bytes, of the pass's clone of the padded
block (``min_bytes``: 2 x 24-29 MB at 256x64x64, about 15-18 us at 3.35
TB/s); the kernel's ghosts and mirrors add about 12% to that. ``python -m
adflow_torch.ops.bc_timing`` measures a pass against it.

The ``autograd.Function`` (``_BCPass``): forward clones the state once and
launches the ops in order on the clone, so a later subface's extended
extent reads the ghosts an earlier one wrote, as in the plain pass. Its jvp
clones the primal and the tangent once and makes one tangent launch an op
in the same order; where the face areas carry a tangent (a jvp in the
coordinates) it runs ``torch.func.jvp`` of the plain pass instead, and its
backward is the plain pass's vjp, as K2's are (``cuda_inviscid.py``).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from adflow_torch.core.mesh import BCType
from adflow_torch.ops import _nvcc

# kernel launches made through ``_launch`` (one an op of a pass, forward or
# tangent)
LAUNCHES = 0

SRC = _nvcc.CSRC / "bc_ghost.cu"

# The BC kinds the kernel computes (bc_ghost.cu Kind): the slip mirror, the
# static no-slip wall, the far field and the zeroth-order extrapolation.
KINDS = {
    BCType.SYMMETRY: 0, BCType.SYMMETRY_POLAR: 0, BCType.EULER_WALL: 0,
    BCType.NS_WALL_ADIABATIC: 1,
    BCType.FARFIELD: 2,
    BCType.SUPERSONIC_OUTFLOW: 3, BCType.EXTRAPOLATE: 3,
}
NW_MAX = 8   # channels a cell the kernel takes at most (bc_ghost.cu)


def _under(t):
    """The tensor under ``t``'s ``torch.func`` wrapper, or ``t`` (or None).
    In the jvp rule every tensor, the saved ones, the tangents and what is
    made from them, is wrapped at the transform's level and has no storage
    of its own; the wrapper's values are those of the tensor under it,
    whose memory the kernel reads and writes, so a write there is the
    wrapper's. This leans on ``torch._C._functorch``, which is private:
    ``test_torch_bc_kernel.py::test_launch_writes_what_the_transform_returns``
    guards it, and the card tests ran it under torch 2.11.0 (CUDA 12.8).
    ``bc._one_func_level`` keeps a pass whose tensors sit deeper than one
    level off the kernel."""
    f = torch._C._functorch
    if t is not None and f.is_functorch_wrapped_tensor(t):
        return f.get_unwrapped(t)
    return t


class OpGeometry(NamedTuple):
    """Where one op's layers lie in the padded state and its faces in the
    face-area array of its axis (``si``, ``sj`` or ``sk``, interior faces):
    ghost layer d at ``ghost[d]`` and its mirror at ``mirror[d]`` along the
    axis; the extended tangential extent ``[lo1, lo1 + n1) x [lo2, lo2 +
    n2)`` in padded indices; the face plane ``face`` of the face array and
    the subface's face range ``[a0, a1) x [b0, b1)`` in interior indices,
    into which a padded tangential index ``p`` maps as ``clamp(p - 2, a0,
    a1 - 1)`` (the plain pass's edge pad over the halo of depth 2); the
    sign that makes the stored normal outward; the kernel's kind."""
    axis: int
    ghost: tuple
    mirror: tuple
    lo1: int
    n1: int
    lo2: int
    n2: int
    face: int
    a0: int
    a1: int
    b0: int
    b1: int
    sign: float
    kind: int


@functools.lru_cache(maxsize=1024)
def op_geometry(op) -> OpGeometry:
    """``op``'s geometry for the kernel, from its static slices (cached: a
    ``BCOp`` without data is hashable, and the kernel takes no other)."""
    ax = op.axis
    t1, t2 = (a for a in range(3) if a != ax)
    g1, g2 = op.ghost[0][t1], op.ghost[0][t2]
    f1, f2 = op.face_sl[t1], op.face_sl[t2]
    return OpGeometry(
        ax, (op.ghost[0][ax], op.ghost[1][ax]),
        (op.mirror[0][ax], op.mirror[1][ax]), g1.start, g1.stop - g1.start,
        g2.start, g2.stop - g2.start, op.face_sl[ax], f1.start, f1.stop,
        f2.start, f2.stop, float(op.sign), KINDS[op.bc])


@functools.lru_cache(maxsize=1)
def _lib():
    lib = ctypes.CDLL(str(_nvcc.build(SRC)))
    fn = lib.bc_ghost_launch
    fn.restype = ctypes.c_int
    # w, dw, s, winf, dwinf; sn, s1, s2, f1, f2, fc; g0, g1, m0, m1, lo1,
    # n1, lo2, n2, a0, a1, b0, b1; sign; kind, nw; stream
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_longlong] * 6
                   + [ctypes.c_int] * 12 + [ctypes.c_float]
                   + [ctypes.c_int] * 2 + [ctypes.c_void_p])
    return lib


def check_operands(w, dw, faces, winf, dwinf):
    """Raise ValueError unless the operands of a pass's launches are float32
    on ``w``'s device: ``w`` (and ``dw``, of its shape) a contiguous padded
    state of 5 to ``NW_MAX`` channels, each of ``faces`` a face-area array
    of 3 components, ``winf`` (and ``dwinf``) of ``w``'s channels,
    contiguous."""
    nw = w.shape[-1]
    if w.dim() != 4 or not 5 <= nw <= NW_MAX:
        raise ValueError(f"w: shape {tuple(w.shape)}, expected (N1, N2, N3, "
                         f"nw) with 5 <= nw <= {NW_MAX}")
    named = {"w": w, "dw": dw, "winf": winf, "dwinf": dwinf,
             **{f"faces[{a}]": f for a, f in enumerate(faces)}}
    for name, t in named.items():
        if t is None:
            continue
        if t.device != w.device:
            raise ValueError(f"{name}: on {t.device}, expected {w.device}")
        if t.dtype != torch.float32:
            raise ValueError(f"{name}: dtype {t.dtype}, the kernel takes "
                             f"float32")
    for name, t, shape in (("dw", dw, w.shape), ("winf", winf, (nw,)),
                           ("dwinf", dwinf, (nw,))):
        if t is not None and tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                             f"{tuple(shape)}")
    for name in ("w", "dw", "winf", "dwinf"):
        if named[name] is not None and not named[name].is_contiguous():
            raise ValueError(f"{name}: not contiguous")
    for a, f in enumerate(faces):
        if f.dim() != 4 or f.shape[-1] != 3:
            raise ValueError(f"faces[{a}]: shape {tuple(f.shape)}, expected "
                             f"a face-area array (.., .., .., 3)")


def _launch(w, dw, s, op, winf, dwinf=None):
    """One op of the pass, in place: the ghosts of ``op`` in ``w`` (the
    forward, ``dw`` None), or their tangent in ``dw`` and their primal in
    ``w`` (the primal copy the tangent pass walks). ``s``: the face-area
    array of ``op``'s axis. The pass checks the operands once
    (``check_operands``)."""
    global LAUNCHES
    g = op_geometry(op)
    _call(*map(_under, (w, dw, s.select(g.axis, g.face), winf, dwinf)), g)
    LAUNCHES += 1


def _call(w, dw, plane, winf, dwinf, g):
    """The C entry point on the plain tensors of one launch: ``plane`` the
    face plane of the op's axis, ``g`` its ``OpGeometry``."""
    if not w.is_cuda:
        raise ValueError(f"w: on {w.device}, the kernel runs on CUDA")
    sw = w.stride()
    t1, t2 = (a for a in range(3) if a != g.axis)
    with torch.cuda.device(w.device):
        stream = torch.cuda.current_stream(w.device).cuda_stream
        err = _lib().bc_ghost_launch(
            w.data_ptr(), None if dw is None else dw.data_ptr(),
            plane.data_ptr(), winf.data_ptr(),
            None if dwinf is None else dwinf.data_ptr(),
            sw[g.axis], sw[t1], sw[t2], *plane.stride(), *g.ghost,
            *g.mirror, g.lo1, g.n1, g.lo2, g.n2, g.a0, g.a1, g.b0, g.b1,
            g.sign, g.kind, w.shape[-1], stream)
    if err != 0:
        raise RuntimeError(f"bc_ghost_launch failed: CUDA error {err}")


def bc_pass_reference(w, metrics, ops, ref, winf, copy=False):
    """The plain pass: ``physics/bc.py`` ``plain_bc_pass``."""
    from adflow_torch.physics.bc import plain_bc_pass
    return plain_bc_pass(w, metrics, ops, ref, winf, copy=copy)


def _faces(siE, sjE, skE):
    """The plain pass's view of the face areas (no face velocity, no
    volumes: the kernel's ops read neither)."""
    from adflow_torch.geom.metrics import BlockMetrics
    return BlockMetrics(siE=siE, sjE=sjE, skE=skE, vol=None, xc_ext=None)


class _BCPass(torch.autograd.Function):
    """The kernel pass over ``consts``' physical ops; its jvp the tangent
    kernel, or the plain pass's where the face areas carry a tangent; its
    backward the plain pass's vjp. ``apply_bcs`` never sends a pass that
    autograd records here (``bc._kernel_applies``), so only a direct caller
    of ``fused_bc_pass`` under autograd reaches the backward."""

    @staticmethod
    def forward(w, winf, siE, sjE, skE, consts):
        ops, _ = consts
        faces = _faces(siE, sjE, skE)
        s = (faces.si, faces.sj, faces.sk)
        out = w.clone(memory_format=torch.contiguous_format)
        winf = winf.contiguous()
        check_operands(out, None, s, winf, None)
        for op in ops:
            _launch(out, None, s[op.axis], op, winf)
        return out

    @staticmethod
    def setup_context(ctx, inputs, output):
        # inputs without a tangent get None, not zeros: the jvp tells a
        # tangent in the face areas from none
        ctx.set_materialize_grads(False)
        ctx.consts = inputs[5]
        ctx.save_for_backward(*inputs[:5])
        ctx.save_for_forward(*inputs[:5])

    @staticmethod
    def backward(ctx, grad_out):
        if grad_out is None:
            return (None,) * 6
        ops, ref = ctx.consts
        _, vjp = torch.func.vjp(
            lambda w, winf, *s: bc_pass_reference(w, _faces(*s), ops, ref,
                                                  winf, copy=True),
            *ctx.saved_tensors)
        return (*vjp(grad_out), None)

    @staticmethod
    def jvp(ctx, *tangents):
        ops, ref = ctx.consts
        w, winf, siE, sjE, skE = ctx.saved_tensors
        tw, twinf = tangents[:2]
        if any(t is not None for t in tangents[2:5]):
            prim = ctx.saved_tensors
            tang = tuple(torch.zeros_like(p) if t is None else t
                         for p, t in zip(prim, tangents[:5]))
            _, out = torch.func.jvp(
                lambda w, winf, *s: bc_pass_reference(w, _faces(*s), ops,
                                                      ref, winf),
                prim, tang)
            return out
        faces = _faces(siE, sjE, skE)
        s = (faces.si, faces.sj, faces.sk)
        prim = w.clone(memory_format=torch.contiguous_format)
        tan = (torch.zeros_like(prim) if tw is None
               else tw.clone(memory_format=torch.contiguous_format))
        winf = winf.contiguous()
        twinf = None if twinf is None else twinf.contiguous()
        check_operands(prim, tan, s, winf, twinf)
        for op in ops:
            _launch(prim, tan, s[op.axis], op, winf, twinf)
        return tan


def fused_bc_pass(w, metrics, ops, ref, winf):
    """The physical-BC pass of one block through the kernel: a new tensor,
    ``w`` with every op's ghost layers written. Same signature and result
    as ``bc_pass_reference`` (to the kernel's float32 rounding)."""
    from adflow_torch.physics.bc import physical_ops
    return _BCPass.apply(w, winf, metrics.siE, metrics.sjE, metrics.skE,
                         (tuple(physical_ops(ops)), ref))


def sample_pass(dims, nw, device, seed=3, amp=0.01, mach=0.84,
                alpha=3.06):
    """One pass's inputs on a ``wing_omesh`` block of ``dims`` interior
    cells (viscous where ``nw`` > 5: 6 SA, 7 SST), float32 on ``device``:
    the padded free stream at ``mach``, ``alpha`` times 1 + ``amp`` seeded
    relative noise; (w, metrics, ops, ref, winf), for checks and timing."""
    import numpy as np

    from adflow_torch.core.refstate import AeroProblem, make_reference_state
    from adflow_torch.geom.metrics import compute_metrics
    from adflow_torch.meshgen.analytic import wing_omesh
    from adflow_torch.physics.bc import build_bc_ops

    f32 = torch.float32
    mesh = wing_omesh(ni=dims[0], nj=dims[1], nk=dims[2], viscous=nw > 5)
    ref = make_reference_state(
        AeroProblem(name="p", mach=mach, alpha=alpha,
                    reynolds=1e6 if nw > 5 else None),
        lift_index=2, n_turb=nw - 5)
    rng = np.random.default_rng(seed)
    w = np.asarray(ref.winf(), np.float32) * (1.0 + amp * rng.standard_normal(
        tuple(n + 4 for n in dims) + (nw,)))
    blk = mesh.blocks[0]
    return (torch.as_tensor(w, dtype=f32, device=device),
            compute_metrics(torch.as_tensor(blk.x, dtype=f32, device=device)),
            tuple(build_bc_ops(blk)), ref,
            torch.as_tensor(ref.winf(), dtype=f32, device=device))


def min_bytes(w):
    """Bytes one pass must move: the clone of the padded state, read once
    and written once."""
    return 2 * w.numel() * w.element_size()
