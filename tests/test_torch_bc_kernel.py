"""The physical-BC pass as one CUDA launch a subface (``ops/cuda_bc.py``,
``csrc/bc_ghost.cu``) and its dispatch in ``physics/bc.py`` ``apply_bcs``.

On the CPU, in float64 (the port's own plain pass is the reference; no
JAX):

- which passes take the kernel: a CUDA float32 state, autograd not
  recording (``requires_grad``, ``torch.func.vjp``), every op of a kind of
  ``cuda_bc.KINDS``, no per-subface data, no face velocity on a wall, no
  wall functions, each turned off in turn;
- the ``autograd.Function``'s forward, jvp and backward, with the launch
  replaced by a per-op CPU twin that follows the kernel's own geometry
  (``cuda_bc.op_geometry``: the layers, the extended extent, the clamped
  face index), bitwise equal to the plain pass and to ``torch.func.jvp`` /
  ``torch.func.vjp`` of it, on the wing for 5, 6 and 7 channels and on a
  block whose faces are split into patches that do not all touch its
  edges; the jvp in the coordinates routed to the plain pass;
- the launch's operand checks.

On a card (marker ``cuda``, skipped without one): the kernel pass against
the plain float32 pass on the 64x24x16 Euler wing, the viscous wing with
SA and SST, and the patched block, every ghost within 2e-6 of its
channel's scale; the tangent against ``torch.func.jvp`` of the plain pass
in float64 within 1e-5; two passes bitwise equal; one ``fill_halos``, one
RK cycle and one ANK jvp matvec through the kernel against the plain path;
no synchronising copy in the kernel pass. The file imports no JAX:
``python -m pytest tests/test_torch_bc_kernel.py -m cuda --noconftest``.
"""

import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from adflow_torch.core.mesh import (
    BCSubface, BCType, Block, Face, MultiBlockMesh)
from adflow_torch.core.refstate import AeroProblem, make_reference_state
from adflow_torch.geom.metrics import compute_metrics
from adflow_torch.meshgen.analytic import wing_omesh
from adflow_torch.ops import cuda_bc
from adflow_torch.physics import bc
from adflow_torch.physics.residual import build_topology
from torch_bc_twin import twin_launch

# The kernel's float32 ghosts and tangents are held to the float64 plain
# pass (``assert_as_close``): by each channel's 2-norm, within these
# shares or as close as the plain float32 pass comes, to a factor of 2; by
# its largest difference, within ``MAX_RTOL`` of its scale (K2's check of a
# float32 kernel against its plain version). Not each ghost within 2e-6:
# at corner cells, where a far-field ghost reads another subface's ghost,
# the state is far from the free stream and the far field's blend,
# d sig / d un_b = 1 / (0.02 c_b), carries float32's rounding of un_b into
# the ghost at 2e-5 to 8e-5 of the momentum's scale, in either float32
# pass, and which pass rounds worse at the worst cell is chance.
GHOST_RTOL = 2e-6
TANGENT_RTOL = 1e-5
MAX_RTOL = 1e-4


def patch_mesh(viscous=False, dims=(6, 7, 5), seed=1):
    """A perturbed box whose imin face is split into 3 x 3 patches of the
    kernel's kinds (the middle one touches no edge of the block) and whose
    other faces carry the rest of them."""
    ni, nj, nk = dims
    xs = [np.linspace(0.0, 1.0, n + 1) for n in dims]
    x = np.stack(np.meshgrid(*xs, indexing="ij"), axis=-1)
    noise = np.random.default_rng(seed).uniform(-0.04, 0.04, x.shape)
    x[1:-1, 1:-1, 1:-1] += noise[1:-1, 1:-1, 1:-1]
    wall = BCType.NS_WALL_ADIABATIC if viscous else BCType.EULER_WALL
    kinds = [BCType.FARFIELD, BCType.SYMMETRY, wall, BCType.EXTRAPOLATE,
             BCType.FARFIELD, BCType.SYMMETRY_POLAR,
             BCType.SUPERSONIC_OUTFLOW, wall, BCType.FARFIELD]
    cuts_j, cuts_k = (0, 2, 5, nj), (0, 1, 3, nk)
    bcs = [BCSubface(Face.IMIN, kinds[3 * a + b], family=f"p{a}{b}",
                     rng=((cuts_j[a], cuts_j[a + 1]),
                          (cuts_k[b], cuts_k[b + 1])))
           for a in range(3) for b in range(3)]
    bcs += [BCSubface(Face.IMAX, BCType.FARFIELD, family="far"),
            BCSubface(Face.JMIN, wall, family="wall"),
            BCSubface(Face.JMAX, BCType.EXTRAPOLATE, family="out"),
            BCSubface(Face.KMIN, BCType.SYMMETRY, family="sym"),
            BCSubface(Face.KMAX, BCType.FARFIELD, family="far2")]
    return MultiBlockMesh([Block("patches", x, bcs)], name="patches")


def case(nw, mesh=None, dims=(16, 8, 8), dtype=torch.float64, device="cpu",
         seed=0, amp=0.01):
    """One block's pass inputs: the padded free stream at M 0.84, alpha 3.06
    times 1 + ``amp`` seeded noise (halos included), its metrics, BC ops,
    reference state and free stream; ``nw`` 5 (Euler), 6 (SA) or 7 (SST)."""
    viscous = nw > 5
    if mesh is None:
        mesh = wing_omesh(ni=dims[0], nj=dims[1], nk=dims[2],
                          viscous=viscous)
    ref = make_reference_state(
        AeroProblem(name="bc", mach=0.84, alpha=3.06,
                    reynolds=1e6 if viscous else None),
        lift_index=2, n_turb=nw - 5)
    blk = mesh.blocks[0]
    w = np.asarray(ref.winf()) * (1.0 + amp * np.random.default_rng(
        seed).standard_normal(tuple(n + 4 for n in blk.dims) + (nw,)))
    return SimpleNamespace(
        w=torch.as_tensor(w, dtype=dtype, device=device),
        m=compute_metrics(torch.as_tensor(blk.x, dtype=dtype, device=device)),
        ops=build_topology(mesh, dtype=dtype, device=device).blocks[0].bc_ops,
        ref=ref, winf=torch.as_tensor(ref.winf(), dtype=dtype,
                                      device=device))


def plain(c, w=None, winf=None, m=None):
    return cuda_bc.bc_pass_reference(c.w if w is None else w,
                                     c.m if m is None else m, c.ops, c.ref,
                                     c.winf if winf is None else winf)


def through_apply(c, w=None, winf=None, m=None):
    return bc.apply_bcs(c.w if w is None else w, c.m if m is None else m,
                        c.ops, c.ref, c.winf if winf is None else winf)


@pytest.fixture
def on_twin(monkeypatch):
    """Let float64 CPU states take the kernel pass, its operands checked as
    their float32 copies and its launches run by the twin; returns a
    function that installs the twin for a case."""
    monkeypatch.setattr(bc, "_kernel_state",
                        lambda w: w.dtype == torch.float64)
    check = cuda_bc.check_operands

    def check_as_float32(w, dw, faces, winf, dwinf):
        f32 = [None if t is None else t.float() for t in (w, dw, winf, dwinf)]
        check(f32[0], f32[1], tuple(f.float() for f in faces), *f32[2:])
    monkeypatch.setattr(cuda_bc, "check_operands", check_as_float32)

    def use(c):
        monkeypatch.setattr(cuda_bc, "_launch", twin_launch(c.ref))
        return c
    return use


def n_physical(c):
    return len(bc.physical_ops(c.ops))


def assert_equal(a, b):
    assert a.shape == b.shape
    assert torch.equal(a, b), float((a - b).abs().max())


# -- dispatch ---------------------------------------------------------------

OFF = ["cpu_float32", "requires_grad", "func_vjp", "nested_jvp", "kind",
       "data", "face_velocity", "wall_fn"]


@pytest.mark.parametrize("off", [None, *OFF])
def test_dispatch(on_twin, off):
    """The kernel pass takes a pass only where every condition holds; with
    each turned off in turn the pass is the plain one, launching nothing,
    with the same result."""
    nw = 6 if off == "wall_fn" else 5
    if off == "cpu_float32":
        c = case(nw, dtype=torch.float32)
    else:
        c = on_twin(case(nw))
    if off == "kind":
        c.ops = tuple(dataclasses.replace(op, bc=BCType.SUBSONIC_OUTFLOW)
                      if op.bc is BCType.FARFIELD else op for op in c.ops)
    elif off == "data":
        c.ops = tuple(dataclasses.replace(op, data={"P": 0.7})
                      if op.bc is BCType.SYMMETRY else op for op in c.ops)
    elif off == "face_velocity":
        c.m = c.m._replace(vfJE=torch.zeros_like(c.m.sjE))
    elif off == "wall_fn":
        c.ref = dataclasses.replace(c.ref, wall_fn=True)
    want = plain(c)
    n0 = cuda_bc.LAUNCHES
    if off == "requires_grad":
        w = c.w.clone().requires_grad_()
        got = through_apply(c, w=w)
        assert got.requires_grad
        got = got.detach()
    elif off == "func_vjp":
        got, vjp = torch.func.vjp(lambda w: through_apply(c, w=w), c.w)
        assert_equal(vjp(torch.ones_like(got))[0], torch.func.vjp(
            lambda w: cuda_bc.bc_pass_reference(w, c.m, c.ops, c.ref, c.winf,
                                                copy=True),
            c.w)[1](torch.ones_like(got))[0])
    elif off == "nested_jvp":
        v = torch.ones_like(c.w)

        def inner(pass_fn):
            return lambda w: torch.func.jvp(lambda u: pass_fn(c, w=u), (w,),
                                            (v,))[1]
        got = torch.func.jvp(inner(through_apply), (c.w,), (v,))[1]
        want = torch.func.jvp(inner(plain), (c.w,), (v,))[1]
    else:
        got = through_apply(c)
    assert cuda_bc.LAUNCHES - n0 == (n_physical(c) if off is None else 0)
    assert_equal(got, want)


def test_wing_has_four_physical_subfaces():
    """The cells' wing: wall, two far fields and symmetry; the i faces are
    its O-mesh cut."""
    c = case(5)
    assert [op.bc for op in bc.physical_ops(c.ops)] == [
        BCType.EULER_WALL, BCType.FARFIELD, BCType.SYMMETRY,
        BCType.FARFIELD]
    assert all(op.bc in cuda_bc.KINDS for op in bc.physical_ops(c.ops))
    assert not bc._kernel_applies(c.w, c.m, c.ops, c.ref, c.winf)


# -- the autograd.Function through the twin ---------------------------------

CASES = [("wing", 5), ("wing", 6), ("wing", 7), ("patches", 5),
         ("patches", 6)]


def make(kind, nw, **kw):
    mesh = patch_mesh(viscous=nw > 5) if kind == "patches" else None
    return case(nw, mesh=mesh, **kw)


@pytest.mark.parametrize("kind,nw", CASES)
def test_forward_matches_plain_pass(on_twin, kind, nw):
    c = on_twin(make(kind, nw))
    n0 = cuda_bc.LAUNCHES
    got = through_apply(c)
    assert cuda_bc.LAUNCHES - n0 == n_physical(c)
    assert_equal(got, plain(c))
    # the caller's state is not written
    assert_equal(c.w, make(kind, nw).w)


@pytest.mark.parametrize("with_winf", [False, True])
@pytest.mark.parametrize("kind,nw", CASES)
def test_jvp_matches_plain_jvp(on_twin, kind, nw, with_winf):
    """The tangent pass (one tangent launch an op after the forward's) is
    ``torch.func.jvp`` of the plain pass, in the state and in the free
    stream."""
    c = on_twin(make(kind, nw))
    rng = np.random.default_rng(7)
    v = torch.as_tensor(rng.standard_normal(tuple(c.w.shape)))
    vinf = torch.as_tensor(rng.standard_normal(nw)) * with_winf
    n0 = cuda_bc.LAUNCHES
    out, tan = torch.func.jvp(lambda w, winf: through_apply(c, w, winf),
                              (c.w, c.winf), (v, vinf))
    assert cuda_bc.LAUNCHES - n0 == 2 * n_physical(c)
    want_out, want_tan = torch.func.jvp(lambda w, winf: plain(c, w, winf),
                                        (c.w, c.winf), (v, vinf))
    assert_equal(out, want_out)
    assert_equal(tan, want_tan)
    assert float(tan.abs().max()) > 0.0


def test_coordinate_tangent_takes_the_plain_jvp(on_twin):
    """A tangent in the face areas (a jvp in the coordinates) is the plain
    pass's jvp: the forward launches, no tangent launch."""
    c = on_twin(case(5))
    rng = np.random.default_rng(8)
    v = torch.as_tensor(rng.standard_normal(tuple(c.w.shape)))
    vs = torch.as_tensor(rng.standard_normal(tuple(c.m.sjE.shape)))

    def f(pass_fn):
        return lambda w, sjE: pass_fn(c, w=w, m=c.m._replace(sjE=sjE))
    n0 = cuda_bc.LAUNCHES
    got = torch.func.jvp(f(through_apply), (c.w, c.m.sjE), (v, vs))
    assert cuda_bc.LAUNCHES - n0 == n_physical(c)
    want = torch.func.jvp(f(plain), (c.w, c.m.sjE), (v, vs))
    for a, b in zip(got, want):
        assert_equal(a, b)
    # the tangent in the areas reaches the ghosts
    _, only_w = torch.func.jvp(f(plain), (c.w, c.m.sjE),
                               (v, torch.zeros_like(vs)))
    assert not torch.equal(got[1], only_w)


def test_backward_is_the_plain_vjp(on_twin):
    """``apply_bcs`` never records through the kernel pass; the Function's
    backward, called directly, is the plain pass's vjp."""
    c = on_twin(case(6))
    w = c.w.clone().requires_grad_()
    winf = c.winf.clone().requires_grad_()
    out = cuda_bc._BCPass.apply(w, winf, c.m.siE, c.m.sjE, c.m.skE,
                                (tuple(c.ops), c.ref))
    cot = torch.as_tensor(np.random.default_rng(9).standard_normal(
        tuple(out.shape)))
    gw, gwinf = torch.autograd.grad(out, (w, winf), cot)
    _, vjp = torch.func.vjp(
        lambda w, winf: cuda_bc.bc_pass_reference(w, c.m, c.ops, c.ref, winf,
                                                  copy=True), c.w, c.winf)
    want_w, want_winf = vjp(cot)
    torch.testing.assert_close(gw, want_w, rtol=1e-12, atol=0)
    torch.testing.assert_close(gwinf, want_winf, rtol=1e-12, atol=0)


def test_launch_writes_what_the_transform_returns(monkeypatch):
    """Inside ``torch.func.jvp`` the rule's tensors are wrapped at the
    transform's level and have no storage; the launch is handed the plain
    tensors under the wrappers, and what it writes there is the primal and
    the tangent the jvp returns. The C call is replaced by one that fills
    its buffers through their pointers."""
    import ctypes

    def fill(t, value):
        np.ctypeslib.as_array((ctypes.c_float * t.numel()).from_address(
            t.data_ptr()))[:] = value

    def call(w, dw, plane, winf, dwinf, g):
        for t in (w, dw, plane, winf, dwinf):
            assert t is None or not \
                torch._C._functorch.is_functorch_wrapped_tensor(t)
            assert t is None or t.data_ptr()
        assert w.is_contiguous() and (dw is None or dw.is_contiguous())
        fill(w, 3.0) if dw is None else fill(dw, 7.0)
    monkeypatch.setattr(bc, "_kernel_state",
                        lambda w: w.dtype == torch.float32)
    monkeypatch.setattr(cuda_bc, "_call", call)
    c = case(5, dtype=torch.float32)
    n0 = cuda_bc.LAUNCHES
    out, tan = torch.func.jvp(lambda w: through_apply(c, w), (c.w,),
                              (torch.ones_like(c.w),))
    assert cuda_bc.LAUNCHES - n0 == 2 * n_physical(c)
    assert bool((out == 3.0).all()) and bool((tan == 7.0).all())
    assert bool((through_apply(c) == 3.0).all())


@pytest.mark.parametrize("fault", ["dtype", "nw", "dw_shape", "winf_shape",
                                   "contiguous", "device", "s_shape"])
def test_operand_checks(fault):
    w = torch.zeros(8, 7, 6, 5)
    s = torch.zeros(5, 3, 2, 3)
    faces = (torch.zeros(5, 3, 2, 3),) * 2
    dw, winf = None, torch.zeros(5)
    if fault == "dtype":
        w = w.double()
    elif fault == "nw":
        w = torch.zeros(8, 7, 6, 9)
    elif fault == "dw_shape":
        dw = torch.zeros(8, 7, 6, 4)
    elif fault == "winf_shape":
        winf = torch.zeros(6)
    elif fault == "contiguous":
        w = torch.zeros(8, 7, 5, 6).transpose(-1, -2)
    elif fault == "device":
        s = torch.zeros(5, 3, 2, 3, device="meta")
    elif fault == "s_shape":
        s = torch.zeros(5, 3, 2, 2)
    with pytest.raises(ValueError):
        cuda_bc.check_operands(w, dw, faces + (s,), winf, None)
    cuda_bc.check_operands(torch.zeros(8, 7, 6, 5), torch.zeros(8, 7, 6, 5),
                           faces, torch.zeros(5), torch.zeros(5))
    with pytest.raises(ValueError, match="CUDA"):
        cuda_bc._launch(torch.zeros(8, 7, 6, 5), None,
                        torch.zeros(5, 3, 2, 3), case(5).ops[2],
                        torch.zeros(5))


# -- the card ---------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda", 0)


def rel_per_channel(want, got):
    """Each channel's largest difference over its largest magnitude."""
    want, got = want.double(), got.double()
    scale = want.abs().amax(dim=(0, 1, 2)) + 1e-30
    return ((got - want).abs().amax(dim=(0, 1, 2)) / scale).tolist()


def in_float64(c):
    """The case's float32 inputs, rounded as they are, in float64."""
    return SimpleNamespace(**{**vars(c), "w": c.w.double(),
                              "winf": c.winf.double(),
                              "m": c.m._replace(siE=c.m.siE.double(),
                                                sjE=c.m.sjE.double(),
                                                skE=c.m.skE.double())})


def norm_per_channel(want, got):
    """Each channel's 2-norm of the difference over its 2-norm."""
    want, got = want.double(), got.double()
    return (torch.linalg.vector_norm(got - want, dim=(0, 1, 2))
            / (torch.linalg.vector_norm(want, dim=(0, 1, 2)) + 1e-300)
            ).tolist()


def assert_as_close(kernel, plain32, exact, floor):
    """Each channel of the kernel's result as close by its 2-norm to the
    float64 plain pass's as ``floor``, or as the plain float32 pass comes
    to a factor of 2, and everywhere within ``MAX_RTOL`` of its scale."""
    k = norm_per_channel(exact, kernel)
    p = norm_per_channel(exact, plain32)
    assert all(a <= max(floor, 2.0 * b) for a, b in zip(k, p)), (k, p)
    worst = rel_per_channel(exact, kernel)
    assert max(worst) < MAX_RTOL, worst


CARD_CASES = [("wing", 5), ("wing", 6), ("wing", 7), ("patches", 5),
              ("patches", 6), ("patches", 7)]


@pytest.mark.cuda
@pytest.mark.parametrize("kind,nw", CARD_CASES)
def test_kernel_matches_plain_on_card(cuda_device, kind, nw):
    dims = (64, 24, 16)
    c = make(kind, nw, dims=dims, dtype=torch.float32, device=cuda_device)
    assert bc._kernel_applies(c.w, c.m, c.ops, c.ref, c.winf)
    n0 = cuda_bc.LAUNCHES
    got = through_apply(c)
    again = through_apply(c)
    torch.cuda.synchronize()
    assert cuda_bc.LAUNCHES - n0 == 2 * n_physical(c)
    assert_as_close(got, plain(c), plain(in_float64(c)), GHOST_RTOL)
    assert torch.equal(got, again)


@pytest.mark.cuda
@pytest.mark.parametrize("kind,nw", CARD_CASES)
def test_tangent_matches_f64_jvp_on_card(cuda_device, kind, nw):
    """The kernel's float32 tangent against ``torch.func.jvp`` of the plain
    pass in float64, at the same (float32-rounded) inputs, in the state and
    in the free stream, as close as the plain float32 pass's jvp comes."""
    dims = (64, 24, 16)
    c = make(kind, nw, dims=dims, dtype=torch.float32, device=cuda_device)
    c64 = in_float64(c)
    gen = torch.Generator(device=cuda_device).manual_seed(5)
    v = torch.randn(c.w.shape, generator=gen, device=cuda_device)
    vinf = torch.randn(c.winf.shape, generator=gen, device=cuda_device)
    n0 = cuda_bc.LAUNCHES
    _, got = torch.func.jvp(lambda w, winf: through_apply(c, w, winf),
                            (c.w, c.winf), (v, vinf))
    torch.cuda.synchronize()
    assert cuda_bc.LAUNCHES - n0 == 2 * n_physical(c)
    _, exact = torch.func.jvp(lambda w, winf: plain(c64, w, winf),
                              (c64.w, c64.winf), (v.double(), vinf.double()))
    _, plain32 = torch.func.jvp(lambda w, winf: plain(c, w, winf),
                                (c.w, c.winf), (v, vinf))
    assert_as_close(got, plain32, exact, TANGENT_RTOL)


@pytest.mark.cuda
def test_no_synchronising_copy_on_card(cuda_device):
    """The kernel pass makes no copy that syncs the card (the plain pass's
    index tensors are pageable host-to-card copies)."""
    import warnings

    c = case(6, dims=(16, 8, 8), dtype=torch.float32, device=cuda_device)
    through_apply(c)   # builds and loads the kernel
    torch.cuda.synchronize()
    seen = {}
    for name, fn in (("kernel", lambda: through_apply(c)),
                     ("plain", lambda: plain(c))):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                fn()
            finally:
                torch.cuda.set_sync_debug_mode("default")
        seen[name] = [str(x.message) for x in caught
                      if "called a synchronizing" in str(x.message)]
    assert seen["kernel"] == []
    assert seen["plain"], "the check sees the plain pass's copies"


def _solver(cuda_device, options, viscous, w=None):
    from adflow_torch import ADFLOW
    s = ADFLOW(options=dict(options, printIterations=False,
                            printTiming=False),
               mesh=wing_omesh(ni=32, nj=16, nk=8, viscous=viscous),
               device=cuda_device)
    ap = AeroProblem(name="bc", mach=0.84, alpha=3.06,
                     reynolds=1e6 if viscous else None,
                     evalFuncs=["cl", "cd"])
    s.setAeroProblem(ap)
    if w is None:
        w = s.getStates()
        gen = torch.Generator(device=w.device).manual_seed(3)
        w = w * (1.0 + 1e-3 * torch.randn(w.shape, generator=gen,
                                           device=w.device, dtype=w.dtype))
    s.setStates(w.to(s.getStates().dtype))
    return s, ap


def _both_routes(monkeypatch, fn):
    """``fn()`` through the kernel pass, then through the plain pass, with
    the kernel's launches of each."""
    n0 = cuda_bc.LAUNCHES
    got = fn()
    launched = cuda_bc.LAUNCHES - n0
    with monkeypatch.context() as mp:
        mp.setattr(bc, "_kernel_applies", lambda *a: False)
        want = fn()
    assert cuda_bc.LAUNCHES - n0 == launched
    torch.cuda.synchronize()
    return got, want, launched


@pytest.mark.cuda
def test_fill_halos_through_kernel_on_card(cuda_device, monkeypatch):
    from adflow_torch.physics.residual import fill_halos
    c = case(6, dims=(64, 24, 16), dtype=torch.float32, device=cuda_device)
    topo = build_topology(wing_omesh(ni=64, nj=24, nk=16, viscous=True),
                          dtype=torch.float32, device=cuda_device)
    got, want, launched = _both_routes(monkeypatch, lambda: fill_halos(
        [c.w], [c.m], topo, c.ref, c.winf)[0])
    assert launched == 2 * 4
    c64 = in_float64(c)
    exact = fill_halos([c64.w], [c64.m], build_topology(
        wing_omesh(ni=64, nj=24, nk=16, viscous=True), dtype=torch.float64,
        device=cuda_device), c64.ref, c64.winf)[0]
    assert_as_close(got, want, exact, GHOST_RTOL)


@pytest.mark.cuda
def test_rk_cycle_through_kernel_on_card(cuda_device, monkeypatch):
    """One RK cycle of the viscous SA wing (K1 in its stages), its 12 BC
    passes through the kernel, against the plain passes: each float32
    cycle's distance from the float64 cycle, as a share of the float64
    cycle's change, the kernel's within 1e-6 or twice the plain passes'."""
    opts = {"equationType": "RANS", "useANKSolver": False,
            "useNKSolver": False, "nCycles": 1}
    s, ap = _solver(cuda_device, opts, viscous=True)
    w0 = s.getStates().clone()

    def cycle():
        s.setStates(w0)
        s(ap)
        return s.getStates().clone()
    got, want, launched = _both_routes(monkeypatch, cycle)
    assert launched == 12 * 4 * s.solve_info.iterations
    s64, ap64 = _solver(cuda_device, dict(opts, precision="float64"),
                        viscous=True, w=w0)
    s64(ap64)
    exact = s64.getStates()
    change = float(torch.linalg.norm(exact - w0.double()))
    k, p = (float(torch.linalg.norm(x.double() - exact)) / change
            for x in (got, want))
    assert change > 0.0 and k <= max(1e-6, 2.0 * p), (k, p)


@pytest.mark.cuda
def test_ank_matvec_through_kernel_on_card(cuda_device, monkeypatch):
    """One jvp matvec of the Euler wing's residual, its fill's two BC
    passes through the kernel pass and its tangent, against the plain
    passes."""
    from adflow_torch.solvers import newton
    s, _ = _solver(cuda_device, {"equationType": "euler"}, viscous=False)
    fns = newton.build_newton_fns(s.w_list, s.metrics_list, s.topo, s.cfg,
                                  s.ref, s.winf, s.extras_list)
    wvec = fns.packer.pack_w(s.w_list)
    gen = torch.Generator(device=wvec.device).manual_seed(4)
    u = torch.randn(wvec.shape, generator=gen, device=wvec.device)
    got, want, launched = _both_routes(monkeypatch, lambda: torch.func.jvp(
        fns.res_flat, (wvec,), (u,))[1])
    assert launched == 2 * 2 * 4
    err = float((got - want).abs().max() / want.abs().max())
    assert err < 1e-4, err
