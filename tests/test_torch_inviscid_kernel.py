"""The inviscid residual (K2) of the port against the JAX package.

On the CPU: the port's plain version in float32 against the JAX package's
Pallas kernel run in interpret mode (``fused_inviscid_residual``, as
tests/test_pallas.py runs it) to 2e-5 relative per channel; in float64
against ``inviscid_residual`` to 1e-12, with and without the coarse-level
constant dissipation; its jvp and vjp against ``jax.jvp``/``jax.vjp``; the
wrapper's CPU route, its operand checks, the ``autograd.Function``'s
backward and jvp through the plain version, and the kernel's tile plan
(``k2_tile_plan``: every interior cell in exactly one block's tile and
segment, the segment at the main path's size, the shared bytes, the copy
width against the row alignment of the 20-byte ``w5`` and 4-byte ``p``
cells). On a card (marker ``cuda``, skipped without one): the CUDA kernel
against the plain version at 2e-5 per channel on the test_pallas.py wing
and on blocks whose sizes are multiples of no tile size, with segments
that do not divide ni and one longer than the block (with 16-byte copies);
two launches bitwise equal; and ``block_residual`` launching it for an
Euler block.

JAX is imported inside the tests that run it, so the card tests run on a
machine without JAX:
``python -m pytest tests/test_torch_inviscid_kernel.py -m cuda --noconftest``.
"""

import numpy as np
import pytest
import torch

from adflow_torch.ops import _nvcc, cuda_inviscid

KERNEL_RTOL = 2e-5
F64_RTOL = 1e-12


def _rel_per_channel(want, got):
    want = np.asarray(want, np.float64)
    got = np.asarray(got, np.float64)
    assert want.shape == got.shape
    return [float(np.abs(want[..., c] - got[..., c]).max()
                  / (np.abs(want[..., c]).max() + 1e-30))
            for c in range(want.shape[-1])]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda", 0)


def _jax_operands(dtype_name):
    """The tests/test_pallas.py setup in the JAX package: the 16x8x8 Euler
    wing at M 0.5, alpha 2 with 1% noise from seed 3, halos filled; the
    eight operands as numpy arrays."""
    import jax.numpy as jnp

    from adflow_tpu.core.refstate import AeroProblem, make_reference_state
    from adflow_tpu.geom.metrics import compute_metrics
    from adflow_tpu.meshgen.analytic import wing_omesh
    from adflow_tpu.physics.residual import build_topology, fill_halos
    from adflow_tpu.physics.thermo import pressure

    dtype = getattr(jnp, dtype_name)
    mesh = wing_omesh(ni=16, nj=8, nk=8)
    ref = make_reference_state(AeroProblem(name="p", mach=0.5, alpha=2.0),
                               lift_index=2, n_turb=0)
    winf = jnp.asarray(ref.winf(), dtype)
    topo = build_topology(mesh)
    m = compute_metrics(jnp.asarray(mesh.blocks[0].x, dtype))
    rng = np.random.default_rng(3)
    w = np.broadcast_to(np.asarray(winf), (20, 12, 12, 5)).copy()
    w *= 1.0 + 0.01 * rng.standard_normal(w.shape)
    (wf,) = fill_halos([jnp.asarray(w, dtype)], [m], topo, ref, winf)
    por = topo.blocks[0].por
    return [np.asarray(a, dtype) for a in
            (wf, pressure(wf), m.siE, m.sjE, m.skE, *por)]


def test_plain_f32_matches_pallas_interpret():
    import jax.numpy as jnp

    from adflow_tpu.ops.pallas_residual import fused_inviscid_residual

    ops = _jax_operands("float32")
    consts = (0.25, 1.0 / 64.0, 0.67)
    want = np.asarray(fused_inviscid_residual(
        *(jnp.asarray(a) for a in ops), *consts))
    got = cuda_inviscid.inviscid_residual_reference(
        *(torch.from_numpy(a) for a in ops), *consts)
    assert got.dtype == torch.float32
    errs = _rel_per_channel(want, got.numpy())
    assert max(errs) < KERNEL_RTOL, errs


@pytest.mark.parametrize("const_diss", [False, True])
def test_plain_f64_matches_jax(const_diss):
    import jax.numpy as jnp

    from adflow_tpu.geom.metrics import BlockMetrics as JaxMetrics
    from adflow_tpu.physics.fluxes import inviscid_residual as jax_inviscid
    from adflow_torch.geom.metrics import BlockMetrics
    from adflow_torch.physics.fluxes import inviscid_residual

    ops = _jax_operands("float64")
    w, p, siE, sjE, skE = ops[:5]
    want = np.asarray(jax_inviscid(
        jnp.asarray(w), jnp.asarray(p),
        JaxMetrics(siE=jnp.asarray(siE), sjE=jnp.asarray(sjE),
                   skE=jnp.asarray(skE), vol=None, xc_ext=None),
        0.25, 1.0 / 64.0, 0.67, por=tuple(jnp.asarray(a) for a in ops[5:]),
        const_diss=const_diss))
    t = [torch.from_numpy(a) for a in ops]
    got = inviscid_residual(
        t[0], t[1], BlockMetrics(siE=t[2], sjE=t[3], skE=t[4], vol=None,
                                 xc_ext=None),
        0.25, 1.0 / 64.0, 0.67, por=tuple(t[5:]), const_diss=const_diss)
    errs = _rel_per_channel(want, got.numpy())
    assert max(errs) < F64_RTOL, errs


def test_plain_derivatives_match_jax():
    """torch.func jvp and vjp of the plain version against jax.jvp and
    jax.vjp of the JAX package's twin (pallas_residual.py:292), in f64 on
    random tangents and cotangents."""
    import jax
    import jax.numpy as jnp

    from adflow_tpu.ops.pallas_residual import _jnp_reference

    ops = _jax_operands("float64")
    consts = (0.25, 1.0 / 64.0, 0.67)
    rest_j = [jnp.asarray(a) for a in ops[1:]]
    rest_t = [torch.from_numpy(a) for a in ops[1:]]
    rng = np.random.default_rng(5)
    tangent = rng.standard_normal(ops[0].shape)
    cot = rng.standard_normal((16, 8, 8, 5))

    def fj(w):
        return _jnp_reference(w, *rest_j, *consts)

    def ft(w):
        return cuda_inviscid.inviscid_residual_reference(w, *rest_t, *consts)

    _, jv_j = jax.jvp(fj, (jnp.asarray(ops[0]),), (jnp.asarray(tangent),))
    _, jv_t = torch.func.jvp(ft, (torch.from_numpy(ops[0]),),
                             (torch.from_numpy(tangent),))
    assert max(_rel_per_channel(jv_j, jv_t.numpy())) < F64_RTOL
    (vj_j,) = jax.vjp(fj, jnp.asarray(ops[0]))[1](jnp.asarray(cot))
    (vj_t,) = torch.func.vjp(ft, torch.from_numpy(ops[0]))[1](
        torch.from_numpy(cot))
    assert max(_rel_per_channel(vj_j, vj_t.numpy())) < F64_RTOL


def test_cpu_wrapper_runs_plain_version():
    tensors, consts = cuda_inviscid.sample_operands((8, 6, 4), "cpu")
    before = cuda_inviscid.LAUNCHES
    got = cuda_inviscid.fused_inviscid_residual(*tensors, *consts)
    assert cuda_inviscid.LAUNCHES == before
    want = cuda_inviscid.inviscid_residual_reference(*tensors, *consts)
    assert torch.equal(got, want)


@pytest.mark.parametrize("fault", ["dtype", "shape", "contiguous", "rank",
                                   "channels"])
def test_operand_checks(fault):
    t, _ = cuda_inviscid.sample_operands((8, 6, 4), "cpu")
    assert cuda_inviscid.check_operands(t) == (8, 6, 4)
    if fault == "dtype":
        t[1] = t[1].double()
    elif fault == "shape":
        t[6] = t[6][:, :-1]
    elif fault == "contiguous":
        t[2] = t[2].transpose(0, 1).contiguous().transpose(0, 1)
    elif fault == "rank":
        t[0] = t[0][..., 0]
    else:
        t[0] = torch.cat([t[0], t[0][..., :1]], dim=-1)
    with pytest.raises(ValueError):
        cuda_inviscid.check_operands(t)


def test_autograd_function_derivatives(monkeypatch):
    """Backward and jvp of the kernel's autograd.Function run the plain
    version (the counterpart of the custom_jvp at pallas_residual.py:302).
    The launch is replaced by the plain version so this runs on the CPU."""
    tensors, consts = cuda_inviscid.sample_operands((6, 4, 4), "cpu")
    t = [a.double() for a in tensors]
    monkeypatch.setattr(
        cuda_inviscid, "_launch",
        lambda ts, *c: cuda_inviscid.inviscid_residual_reference(*ts, *c))

    def fused(w):
        return cuda_inviscid._FusedInviscid.apply(w, *t[1:], consts)

    def plain(w):
        return cuda_inviscid.inviscid_residual_reference(w, *t[1:], *consts)

    rng = np.random.RandomState(3)
    tangent = torch.tensor(rng.randn(*t[0].shape))
    cot = torch.tensor(rng.randn(6, 4, 4, 5))
    out_f, jvp_f = torch.func.jvp(fused, (t[0],), (tangent,))
    out_p, jvp_p = torch.func.jvp(plain, (t[0],), (tangent,))
    torch.testing.assert_close(out_f, out_p, rtol=0, atol=0)
    torch.testing.assert_close(jvp_f, jvp_p, rtol=1e-12, atol=0)
    (vjp_f,) = torch.func.vjp(fused, t[0])[1](cot)
    (vjp_p,) = torch.func.vjp(plain, t[0])[1](cot)
    torch.testing.assert_close(vjp_f, vjp_p, rtol=1e-12, atol=0)
    assert float(torch.abs(vjp_p).max()) > 0.0


PLAN_DIMS = [(16, 8, 8), (15, 7, 5), (2, 3, 5), (256, 64, 64)]


@pytest.mark.parametrize("si", [None, 5])
@pytest.mark.parametrize("dims", PLAN_DIMS)
def test_tile_plan_covers_each_cell_once(dims, si):
    ni, nj, nk = dims
    plan = cuda_inviscid.k2_tile_plan(ni, nj, nk, si=si)
    assert plan.threads == (cuda_inviscid.K2_THREADS_PER_COLUMN * plan.tj
                            * plan.tk)
    cover = np.zeros(dims, np.int32)
    gx, gy, gz = plan.grid
    for z in range(gz):
        for y in range(gy):
            for x in range(gx):
                cells = cover[z * plan.si:(z + 1) * plan.si,
                              y * plan.tj:(y + 1) * plan.tj,
                              x * plan.tk:(x + 1) * plan.tk]
                assert cells.size > 0, (x, y, z)
                cells += 1
    assert (cover == 1).all()


def test_tile_plan_segment_fills_waves():
    """At the main path's size the segment makes the blocks whole waves of
    K2_BLOCKS_PER_SM blocks on each of 132 SMs, and no shorter segment
    needs fewer waves x (planes + warm-up)."""
    plan = cuda_inviscid.k2_tile_plan(256, 64, 64)
    n_blocks = plan.grid[0] * plan.grid[1] * plan.grid[2]
    per_wave = cuda_inviscid.K2_BLOCKS_PER_SM * _nvcc.N_SM
    waves = -(-n_blocks // per_wave)
    assert n_blocks <= waves * per_wave
    assert n_blocks > (waves - 1) * per_wave
    tiles = plan.grid[0] * plan.grid[1]
    for si in range(_nvcc.MIN_SEGMENT, 257):
        w = -(-(-(-256 // si) * tiles) // per_wave)
        assert w * (si + 1) >= waves * (plan.si + 1)
    assert cuda_inviscid.k2_tile_plan(3, 11, 7).si == 3


def test_tile_plan_shared_bytes():
    """The shared memory fits a block, the blocks per SM that its
    __launch_bounds__ asks for fit the SM's 228 KB (1 KB of it reserved per
    block), and the plan's bytes are the source's."""
    plan = cuda_inviscid.k2_tile_plan(256, 64, 64)
    assert plan.smem_bytes <= _nvcc.SMEM_LIMIT
    assert (cuda_inviscid.K2_BLOCKS_PER_SM
            * (plan.smem_bytes + _nvcc.SMEM_RESERVED)) <= _nvcc.SM_SMEM
    assert plan.smem_bytes % 16 == 0
    assert plan.smem_bytes == 48_480
    src = cuda_inviscid.SRC.read_text()
    assert "constexpr int TJ = 8, TK = 16;" in src
    assert (f"constexpr int TPC = "
            f"{cuda_inviscid.K2_THREADS_PER_COLUMN};") in src
    assert (f"constexpr int MIN_BLOCKS = "
            f"{cuda_inviscid.K2_BLOCKS_PER_SM};") in src


@pytest.mark.parametrize("dims", PLAN_DIMS)
def test_tile_plan_copy_width_divides_row_alignment(dims):
    """Every row of w5 (20 bytes a cell) and of p (4 bytes a cell) the
    kernel copies starts at a byte offset, and spans a byte count, that the
    copy width divides; 16-byte rows lie inside the block. The main path's
    256x64x64 gets 16-byte copies."""
    ni, nj, nk = dims
    plan = cuda_inviscid.k2_tile_plan(ni, nj, nk)
    width = plan.copy_width
    rows = np.arange((ni + 4) * (nj + 4), dtype=np.int64)[:, None]
    k0 = np.arange(plan.grid[0], dtype=np.int64)[None, :] * plan.tk
    for cell_bytes in (20, 4):
        starts = (rows * (nk + 4) + k0) * cell_bytes
        assert (starts % width == 0).all()
        assert (plan.tk + 4) * cell_bytes % width == 0
    if width == 16:
        assert (k0 + plan.tk + 4 <= nk + 4).all()
    else:
        assert width == 4
    assert (width == 16) == (dims == (256, 64, 64))


@pytest.mark.cuda
@pytest.mark.parametrize("dims", [(16, 8, 8), (15, 7, 5), (37, 19, 33),
                                  (9, 8, 16)])
def test_kernel_matches_plain_on_card(cuda_device, dims):
    tensors, consts = cuda_inviscid.sample_operands(dims, cuda_device)
    before = cuda_inviscid.LAUNCHES
    got = cuda_inviscid.fused_inviscid_residual(*tensors, *consts)
    torch.cuda.synchronize()
    assert cuda_inviscid.LAUNCHES == before + 1
    want = cuda_inviscid.inviscid_residual_reference(*tensors, *consts)
    errs = _rel_per_channel(want.cpu().numpy(), got.cpu().numpy())
    assert max(errs) < KERNEL_RTOL, errs


@pytest.mark.cuda
@pytest.mark.parametrize("dims,si", [((37, 19, 33), 1), ((37, 19, 33), 5),
                                     ((9, 8, 16), 16)])
def test_kernel_segments_match_plain_on_card(cuda_device, dims, si):
    """Segments that do not divide ni, down to one plane each, and one
    longer than the block (with 16-byte copies)."""
    tensors, consts = cuda_inviscid.sample_operands(dims, cuda_device)
    plan = cuda_inviscid.k2_tile_plan(*dims, si=si)
    assert (plan.copy_width == 16) == (dims == (9, 8, 16))
    got = cuda_inviscid._launch(tensors, *consts, plan=plan)
    torch.cuda.synchronize()
    want = cuda_inviscid.inviscid_residual_reference(*tensors, *consts)
    errs = _rel_per_channel(want.cpu().numpy(), got.cpu().numpy())
    assert max(errs) < KERNEL_RTOL, errs


@pytest.mark.cuda
def test_kernel_launches_bitwise_equal_on_card(cuda_device):
    tensors, consts = cuda_inviscid.sample_operands((37, 19, 33),
                                                    cuda_device)
    a = cuda_inviscid.fused_inviscid_residual(*tensors, *consts)
    b = cuda_inviscid.fused_inviscid_residual(*tensors, *consts)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


@pytest.mark.cuda
def test_kernel_refuses_float64_on_card(cuda_device):
    tensors, consts = cuda_inviscid.sample_operands((8, 6, 4), cuda_device)
    t = [a.double() for a in tensors]
    with pytest.raises(ValueError, match="float32"):
        cuda_inviscid.fused_inviscid_residual(*t, *consts)


@pytest.mark.cuda
def test_block_residual_launches_kernel_on_card(cuda_device):
    """An Euler block on the card goes through K2, once per evaluation, and
    equals the plain path."""
    import dataclasses

    from adflow_torch.core.refstate import AeroProblem, make_reference_state
    from adflow_torch.geom.metrics import compute_metrics
    from adflow_torch.meshgen.analytic import wing_omesh
    from adflow_torch.physics.residual import (
        ProblemConfig, block_residual, build_topology, fill_halos)

    mesh = wing_omesh(ni=16, nj=8, nk=8)
    ref = make_reference_state(AeroProblem(name="p", mach=0.5, alpha=2.0),
                               lift_index=2, n_turb=0)
    f32 = torch.float32
    winf = torch.as_tensor(ref.winf(), dtype=f32, device=cuda_device)
    topo = build_topology(mesh, dtype=f32, device=cuda_device)
    m = compute_metrics(torch.as_tensor(mesh.blocks[0].x, dtype=f32,
                                        device=cuda_device))
    w = winf.expand(20, 12, 12, 5) * (1.0 + 0.01 * torch.randn(
        20, 12, 12, 5, device=cuda_device, generator=torch.Generator(
            device=cuda_device).manual_seed(0)))
    (wf,) = fill_halos([w], [m], topo, ref, winf)
    cfg = ProblemConfig(equation_type="euler", vis2=0.25, vis4=1.0 / 64.0,
                        diss_exponent=0.67, use_kernels=True)
    before = cuda_inviscid.LAUNCHES
    got = block_residual(wf, m, cfg, ref, por=topo.blocks[0].por)
    assert cuda_inviscid.LAUNCHES == before + 1
    want = block_residual(wf, m, dataclasses.replace(cfg, use_kernels=False),
                          ref, por=topo.blocks[0].por)
    assert cuda_inviscid.LAUNCHES == before + 1
    errs = _rel_per_channel(want.cpu().numpy(), got.cpu().numpy())
    assert max(errs) < KERNEL_RTOL, errs
