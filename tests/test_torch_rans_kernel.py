"""The fused RANS-SA residual (K1) of the port against the JAX package.

On the CPU: the port's plain version in float32 against the JAX package's
Pallas kernel run in interpret mode (``_pallas_impl``, as
tests/test_pallas_rans.py runs it) to 2e-5 relative per channel, the
wrapper's CPU route, its operand checks, and the ``autograd.Function``'s
backward and jvp through the plain version, and the kernel's tile plan
(``k1_tile_plan``: every interior cell in exactly one block's tile and
segment, the shared bytes, the copy width against the row alignment). On a
card (marker ``cuda``, skipped without one): the CUDA kernel against the
plain version at 2e-5 per channel, on the test_pallas_rans.py wing, on
blocks whose sizes are multiples of no tile size, with segments that do
not divide ni and one longer than the block; and two launches bitwise
equal.

JAX is imported inside the one test that runs it, so the card tests run on
a machine without JAX:
``python -m pytest tests/test_torch_rans_kernel.py -m cuda --noconftest``.
"""

import numpy as np
import pytest
import torch

from adflow_torch.ops import _nvcc, cuda_rans

KERNEL_RTOL = 2e-5


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


def test_plain_f32_matches_pallas_interpret():
    import jax.numpy as jnp

    from adflow_tpu.ops.pallas_rans import _pallas_impl

    tensors, consts = cuda_rans.sample_operands((24, 12, 8), "cpu")
    want = np.asarray(_pallas_impl(
        *(jnp.asarray(t.numpy()) for t in tensors), *consts))
    got = cuda_rans.rans_residual_reference(*tensors, *consts)
    assert got.dtype == torch.float32
    errs = _rel_per_channel(want, got.numpy())
    assert max(errs) < KERNEL_RTOL, errs


def test_cpu_wrapper_runs_plain_version():
    tensors, consts = cuda_rans.sample_operands((8, 6, 4), "cpu")
    before = cuda_rans.LAUNCHES
    got = cuda_rans.fused_rans_residual(*tensors, *consts)
    assert cuda_rans.LAUNCHES == before
    want = cuda_rans.rans_residual_reference(*tensors, *consts)
    assert torch.equal(got, want)


@pytest.mark.parametrize("fault", ["dtype", "shape", "contiguous", "rank"])
def test_operand_checks(fault):
    t, _ = cuda_rans.sample_operands((8, 6, 4), "cpu")
    assert cuda_rans.check_operands(t) == (8, 6, 4)
    if fault == "dtype":
        t[4] = t[4].double()
    elif fault == "shape":
        t[7] = t[7][:-1]
    elif fault == "contiguous":
        t[1] = t[1].transpose(0, 1).contiguous().transpose(0, 1)
    else:
        t[0] = t[0][..., 0]
    with pytest.raises(ValueError):
        cuda_rans.check_operands(t)


def test_autograd_function_derivatives(monkeypatch):
    """Backward and jvp of the kernel's autograd.Function run the plain
    version (the counterpart of the custom_jvp at pallas_rans.py:633-657).
    The launch is replaced by the plain version so this runs on the CPU."""
    tensors, consts = cuda_rans.sample_operands((6, 4, 4), "cpu")
    t = [a.double() for a in tensors]
    monkeypatch.setattr(
        cuda_rans, "_launch",
        lambda ts, *c: cuda_rans.rans_residual_reference(*ts, *c))

    def fused(w):
        return cuda_rans._FusedRans.apply(w, *t[1:], consts)

    def plain(w):
        return cuda_rans.rans_residual_reference(w, *t[1:], *consts)

    rng = np.random.RandomState(3)
    tangent = torch.tensor(rng.randn(*t[0].shape))
    cot = torch.tensor(rng.randn(6, 4, 4, 6))
    out_f, jvp_f = torch.func.jvp(fused, (t[0],), (tangent,))
    out_p, jvp_p = torch.func.jvp(plain, (t[0],), (tangent,))
    torch.testing.assert_close(out_f, out_p, rtol=0, atol=0)
    torch.testing.assert_close(jvp_f, jvp_p, rtol=1e-12, atol=0)
    (vjp_f,) = torch.func.vjp(fused, t[0])[1](cot)
    (vjp_p,) = torch.func.vjp(plain, t[0])[1](cot)
    torch.testing.assert_close(vjp_f, vjp_p, rtol=1e-12, atol=0)
    assert float(torch.abs(vjp_p).max()) > 0.0


PLAN_DIMS = [(24, 12, 8), (23, 11, 7), (2, 3, 5), (256, 64, 64)]


@pytest.mark.parametrize("si", [None, 5])
@pytest.mark.parametrize("dims", PLAN_DIMS)
def test_tile_plan_covers_each_cell_once(dims, si):
    ni, nj, nk = dims
    plan = cuda_rans.k1_tile_plan(ni, nj, nk, si=si)
    assert plan.threads == 2 * plan.tj * plan.tk
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
    """At the main path's size the segment makes the blocks one wave of two
    blocks on each of 132 SMs (measured best on the card, PERF.md)."""
    plan = cuda_rans.k1_tile_plan(256, 64, 64)
    n_blocks = plan.grid[0] * plan.grid[1] * plan.grid[2]
    assert plan.si == 32 and n_blocks <= 2 * 132
    assert cuda_rans.k1_tile_plan(3, 11, 7).si == 3


def test_tile_plan_shared_bytes():
    """The shared memory fits a block, and the blocks per SM that its
    __launch_bounds__ asks for fit the SM's 228 KB (1 KB of it reserved per
    block)."""
    plan = cuda_rans.k1_tile_plan(256, 64, 64)
    assert plan.smem_bytes <= _nvcc.SMEM_LIMIT
    assert (cuda_rans.K1_BLOCKS_PER_SM
            * (plan.smem_bytes + _nvcc.SMEM_RESERVED)) <= _nvcc.SM_SMEM
    assert plan.smem_bytes % 16 == 0
    assert plan.smem_bytes == 93_632


@pytest.mark.parametrize("dims", PLAN_DIMS)
def test_tile_plan_copy_width_divides_row_alignment(dims):
    """Every row of w the kernel copies starts at a byte offset, and spans a
    byte count, that the copy width divides; 16-byte rows lie inside the
    block. The main path's 256x64x64 gets 16-byte copies."""
    ni, nj, nk = dims
    plan = cuda_rans.k1_tile_plan(ni, nj, nk)
    width = plan.copy_width
    rows = np.arange((ni + 4) * (nj + 4), dtype=np.int64)[:, None]
    k0 = np.arange(plan.grid[0], dtype=np.int64)[None, :] * plan.tk
    starts = (rows * (nk + 4) + k0) * 24
    assert (starts % width == 0).all()
    if width == 16:
        assert (plan.tk + 4) * 24 % 16 == 0
        assert (k0 + plan.tk + 4 <= nk + 4).all()
    else:
        assert width == 4
    assert (width == 16) == (dims == (256, 64, 64))


@pytest.mark.cuda
@pytest.mark.parametrize("dims", [(24, 12, 8), (23, 11, 7), (37, 19, 33),
                                  (9, 8, 16)])
def test_kernel_matches_plain_on_card(cuda_device, dims):
    tensors, consts = cuda_rans.sample_operands(dims, cuda_device)
    before = cuda_rans.LAUNCHES
    got = cuda_rans.fused_rans_residual(*tensors, *consts)
    torch.cuda.synchronize()
    assert cuda_rans.LAUNCHES == before + 1
    want = cuda_rans.rans_residual_reference(*tensors, *consts)
    errs = _rel_per_channel(want.cpu().numpy(), got.cpu().numpy())
    assert max(errs) < KERNEL_RTOL, errs


@pytest.mark.cuda
@pytest.mark.parametrize("dims,si", [((37, 19, 33), 1), ((37, 19, 33), 5),
                                     ((9, 8, 16), 16)])
def test_kernel_segments_match_plain_on_card(cuda_device, dims, si):
    """Segments that do not divide ni, down to one plane each, and one
    longer than the block (with 16-byte copies)."""
    tensors, consts = cuda_rans.sample_operands(dims, cuda_device)
    plan = cuda_rans.k1_tile_plan(*dims, si=si)
    assert (plan.copy_width == 16) == (dims == (9, 8, 16))
    got = cuda_rans._launch(tensors, *consts, plan=plan)
    torch.cuda.synchronize()
    want = cuda_rans.rans_residual_reference(*tensors, *consts)
    errs = _rel_per_channel(want.cpu().numpy(), got.cpu().numpy())
    assert max(errs) < KERNEL_RTOL, errs


@pytest.mark.cuda
def test_kernel_launches_bitwise_equal_on_card(cuda_device):
    tensors, consts = cuda_rans.sample_operands((37, 19, 33), cuda_device)
    a = cuda_rans.fused_rans_residual(*tensors, *consts)
    b = cuda_rans.fused_rans_residual(*tensors, *consts)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


@pytest.mark.cuda
def test_kernel_refuses_float64_on_card(cuda_device):
    tensors, consts = cuda_rans.sample_operands((8, 6, 4), cuda_device)
    t = [a.double() for a in tensors]
    with pytest.raises(ValueError, match="float32"):
        cuda_rans.fused_rans_residual(*t, *consts)
