"""The fused RANS-SA residual (K1) of the port against the JAX package.

On the CPU: the port's plain version in float32 against the JAX package's
Pallas kernel run in interpret mode (``_pallas_impl``, as
tests/test_pallas_rans.py runs it) to 2e-5 relative per channel, the
wrapper's CPU route, its operand checks, and the ``autograd.Function``'s
backward and jvp through the plain version. On a card (marker ``cuda``,
skipped without one): the CUDA kernel against the plain version at 2e-5 per
channel, on the test_pallas_rans.py wing and on a block whose sizes are
multiples of no block size.

JAX is imported inside the one test that runs it, so the card tests run on
a machine without JAX:
``python -m pytest tests/test_torch_rans_kernel.py -m cuda --noconftest``.
"""

import numpy as np
import pytest
import torch

from adflow_torch.ops import cuda_rans

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


@pytest.mark.cuda
@pytest.mark.parametrize("dims", [(24, 12, 8), (23, 11, 7)])
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
def test_kernel_refuses_float64_on_card(cuda_device):
    tensors, consts = cuda_rans.sample_operands((8, 6, 4), cuda_device)
    t = [a.double() for a in tensors]
    with pytest.raises(ValueError, match="float32"):
        cuda_rans.fused_rans_residual(*t, *consts)
