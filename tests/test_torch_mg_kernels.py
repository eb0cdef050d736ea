"""The multigrid coarse levels' kernels: K1's coarse-level instantiation
(``ops/cuda_rans.py``, ``coarse=True``) and the residual-smoothing kernel
(``ops/cuda_irs.py``).

On the CPU: K1's plain version with ``coarse`` against the plain residual
of a coarse level (``block_residual`` with ``coarse_level``: the JST
residual with constant dissipation, ``const_diss``, the viscous and SA
residuals) at the three multigrid levels' dims scaled down, bitwise in
float64; the flag through the kernel's ``autograd.Function`` and its jvp;
which levels ``_level_cfg`` and ``_kernel_applies`` send to the kernel.
The smoothing kernel's launch replaced by its CPU twin
(``tests/torch_irs_twin.py``) against the plain ``residual_averaging``
for every axis and nv 5 and 6, to round-off in float64; its operand
checks, its kept line factors, its launch count.

On a card (marker ``cuda``, skipped without one): both kernels at the
three levels' dims of the 256x64x64 wing against the float64 plain path,
the dispatch of the smoothing, and no synchronising copy under it:
``python -m pytest tests/test_torch_mg_kernels.py -m cuda --noconftest``.
"""

import types

import numpy as np
import pytest
import torch

from adflow_torch.geom.metrics import BlockMetrics
from adflow_torch.ops import cuda_irs, cuda_rans
from adflow_torch.physics import residual
from adflow_torch.physics.residual import ProblemConfig
from adflow_torch.solvers import multigrid as mg
from adflow_torch.solvers import smoothers
from torch_irs_twin import twin_launch

# the three levels of the 256x64x64 wing, and the same shapes scaled down
LEVEL_DIMS = [(256, 64, 64), (128, 32, 32), (64, 16, 16)]
SMALL_DIMS = [(32, 8, 8), (16, 4, 4), (8, 2, 2)]
VIS2_COARSE = 0.5
# float64 round-off of the smoothing's two sweeps: a few units in the last
# place of the block's scale
ULPS = 1e-14


def _rel(want, got):
    return float(torch.abs(got.double() - want).max()
                 / torch.abs(want).max().clamp_min(1e-300))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda", 0)


def _operands(dims, device, dtype):
    tensors, consts = cuda_rans.sample_operands(dims, device)
    return [t.to(dtype) for t in tensors], consts


def _coarse_consts(consts):
    """The sample's constants with vis2Coarse in place of vis2."""
    return (VIS2_COARSE,) + tuple(consts[1:])


def _plain_coarse_level(tensors, consts):
    """The plain residual of a coarse level (``block_residual``'s plain
    route with ``coarse_level``) on the kernel's operands."""
    w, siE, sjE, skE, vol, xc, dist, porI, porJ, porK = tensors
    vis2, vis4, expo, mu_inf, t_inf_dim, use_ft2, turb_scale = consts
    cfg = ProblemConfig(equation_type="rans", vis2=vis2, vis4=vis4,
                        diss_exponent=expo, turb_res_scale=turb_scale,
                        use_ft2=use_ft2, coarse_level=True)
    m = BlockMetrics(siE=siE, sjE=sjE, skE=skE, vol=vol, xc_ext=xc)
    ref = types.SimpleNamespace(mu_inf=mu_inf, t_inf_dim=t_inf_dim)
    return residual.block_residual(w, m, cfg, ref, {"walldist": dist},
                                   por=(porI, porJ, porK))


@pytest.mark.parametrize("dims", SMALL_DIMS)
def test_coarse_plain_version_is_the_coarse_level_residual(dims):
    """K1's plain version with ``coarse`` computes what the plain path of a
    coarse level computes: the same operations in the same order, so the
    same bits in float64. It differs from the fine scheme (the sensor and
    the 4th difference are gone)."""
    t, consts = _operands(dims, "cpu", torch.float64)
    c = _coarse_consts(consts)
    got = cuda_rans.rans_residual_reference(*t, *c, coarse=True)
    want = _plain_coarse_level(t, c)
    assert got.shape == dims + (6,)
    assert torch.equal(got, want)
    fine = cuda_rans.rans_residual_reference(*t, *c)
    assert float(torch.abs(fine - got).max()) > 1e-6 * float(
        torch.abs(got).max())


def test_coarse_flag_through_the_function(monkeypatch):
    """The ``autograd.Function`` hands ``coarse`` to the launch and to the
    plain version its jvp and backward run. The launch is replaced by the
    plain version so this runs on the CPU."""
    t, consts = _operands((8, 6, 4), "cpu", torch.float64)
    c = _coarse_consts(consts)
    seen = []

    def launch(ts, *args):
        seen.append(args[-1])
        return cuda_rans.rans_residual_reference(*ts, *args)

    monkeypatch.setattr(cuda_rans, "_launch", launch)

    def fused(w):
        return cuda_rans._FusedRans.apply(w, *t[1:], c[3], c[4],
                                          c[:3] + c[5:] + (True,))

    def plain(w):
        return cuda_rans.rans_residual_reference(w, *t[1:], *c, coarse=True)

    tangent = torch.tensor(np.random.RandomState(5).randn(*t[0].shape))
    out_f, jvp_f = torch.func.jvp(fused, (t[0],), (tangent,))
    out_p, jvp_p = torch.func.jvp(plain, (t[0],), (tangent,))
    assert seen == [True]
    torch.testing.assert_close(out_f, out_p, rtol=0, atol=0)
    torch.testing.assert_close(jvp_f, jvp_p, rtol=1e-12, atol=0)
    (vjp_f,) = torch.func.vjp(fused, t[0])[1](out_p)
    (vjp_p,) = torch.func.vjp(plain, t[0])[1](out_p)
    torch.testing.assert_close(vjp_f, vjp_p, rtol=1e-12, atol=0)


@pytest.mark.parametrize("fine,kernel", [
    ("central plus scalar dissipation", True),
    ("central plus matrix dissipation", False),
    ("upwind", False)])
def test_coarse_levels_take_k1_for_the_central_scalar_scheme(fine, kernel):
    """``_level_cfg`` keeps the kernels on the coarse levels of a central
    scalar fine scheme only; ``_kernel_applies`` then admits the coarse
    level on a float32 CUDA state (a stand-in here: it reads only the
    state's dtype and device)."""
    cfg = ProblemConfig(equation_type="rans", vis2=0.25, vis4=0.0156,
                        diss_exponent=0.67, discretization=fine,
                        turb_res_scale=1e4, use_kernels=True)
    coarse = mg._level_cfg(cfg, 1)
    assert coarse.coarse_level and coarse.vis2 == mg.VIS2_COARSE
    assert coarse.use_kernels == kernel
    w = types.SimpleNamespace(dtype=torch.float32, is_cuda=True)
    m = types.SimpleNamespace(vfIE=None)
    por = (None, None, None)
    assert residual._kernel_applies(w, m, coarse, {"walldist": None},
                                    por) == kernel
    assert residual._kernel_applies(w, m, mg._level_cfg(cfg, 0),
                                    {"walldist": None}, por) == (
        fine == "central plus scalar dissipation")
    assert not residual._inviscid_kernel_applies(w, m, coarse, por)


# -- the smoothing kernel ---------------------------------------------------

def _smoothed_by_twin(monkeypatch, r, eps):
    monkeypatch.setattr(smoothers, "_irs_kernel_applies", lambda r: True)
    monkeypatch.setattr(cuda_irs, "_launch", twin_launch)
    before = cuda_irs.LAUNCHES
    out = smoothers.residual_averaging(r, eps)
    return out, cuda_irs.LAUNCHES - before


@pytest.mark.parametrize("nv", [5, 6])
@pytest.mark.parametrize("axis", [0, 1, 2])
def test_twin_matches_plain_smoothing_along_each_axis(monkeypatch, axis, nv):
    """One axis at a time (the other two shorter than 3 cells, which the
    smoothing leaves alone): the kernel's lines, addresses and sweeps give
    the plain sweeps' values in float64 to a few units in the last place
    (the plain sweep's ``addcmul_`` may round its multiply-add once where
    the twin rounds twice)."""
    shape = [2, 2, 2, nv]
    shape[axis] = 11
    r = torch.tensor(np.random.default_rng(axis + 10 * nv).standard_normal(
        shape))
    got, launches = _smoothed_by_twin(monkeypatch, r, 0.5)
    assert launches == 1
    want = smoothers.plain_residual_averaging(r, 0.5)
    assert _rel(want, got) < ULPS
    assert float(torch.abs(want - r).max()) > 0.1


@pytest.mark.parametrize("nv", [5, 6])
def test_twin_matches_plain_smoothing_of_a_block(monkeypatch, nv):
    """All three axes in turn, one launch each, on a block of unequal
    sides."""
    r = torch.tensor(np.random.default_rng(nv).standard_normal(
        (9, 6, 5, nv)))
    got, launches = _smoothed_by_twin(monkeypatch, r, 0.5)
    assert launches == 3
    assert _rel(smoothers.plain_residual_averaging(r, 0.5), got) < ULPS


def test_smoothing_dispatch_on_the_cpu():
    r = torch.zeros((4, 4, 4, 6), dtype=torch.float32)
    assert not smoothers._irs_kernel_applies(r)
    before = cuda_irs.LAUNCHES
    smoothers.residual_averaging(r, 0.5)
    assert cuda_irs.LAUNCHES == before


def test_line_factors_are_kept():
    """The factors are made once per (n, eps, dtype, device): the same
    tensor at every call, holding ``averaging_factors`` rounded to the
    dtype."""
    a = cuda_irs.line_factors(7, 0.5, torch.float32, torch.device("cpu"))
    assert a is cuda_irs.line_factors(7, 0.5, torch.float32,
                                      torch.device("cpu"))
    want = np.stack(cuda_irs.averaging_factors(7, 0.5)).astype(np.float32)
    assert a.shape == (3, 7) and np.array_equal(a.numpy(), want)


def test_line_factors_first_made_under_a_transform_are_plain():
    """A first call inside ``torch.func.jvp`` (the plain smoothing under an
    ANK-style jvp) keeps a plain tensor, which later calls outside any
    transform can hand to the kernel."""
    r = torch.tensor(np.random.default_rng(2).standard_normal((13, 2, 2, 6)))
    cuda_irs.line_factors.cache_clear()
    torch.func.jvp(lambda a: smoothers.residual_averaging(a, 0.25), (r,),
                   (torch.ones_like(r),))
    fac = cuda_irs.line_factors(13, 0.25, r.dtype, r.device)
    assert not torch._C._functorch.is_functorch_wrapped_tensor(fac)
    assert not fac.requires_grad and fac.data_ptr() != 0


@pytest.mark.parametrize("fault", ["dtype", "shape", "contiguous", "nv",
                                   "same", "factors"])
def test_smoothing_operand_checks(fault):
    src = torch.zeros((6, 5, 4, 6), dtype=torch.float32)
    dst = torch.empty_like(src)
    fac = cuda_irs.line_factors(5, 0.5, torch.float32, torch.device("cpu"))
    cuda_irs.check_operands(src, dst, fac, 1)
    if fault == "dtype":
        dst = dst.double()
    elif fault == "shape":
        dst = dst[:-1]
    elif fault == "contiguous":
        dst = torch.empty((6, 4, 5, 6)).transpose(1, 2)
    elif fault == "nv":
        src, dst = src[..., :4], dst[..., :4].contiguous()
    elif fault == "same":
        dst = src
    else:
        fac = cuda_irs.line_factors(6, 0.5, torch.float32,
                                    torch.device("cpu"))
    with pytest.raises(ValueError):
        cuda_irs.check_operands(src, dst, fac, 1)


def test_line_plan():
    assert cuda_irs.line_plan((8, 6, 4, 6), 0) == (8, 24, 24)
    assert cuda_irs.line_plan((8, 6, 4, 6), 1) == (6, 4, 32)
    assert cuda_irs.line_plan((8, 6, 4, 6), 2) == (4, 1, 48)


# -- the card ---------------------------------------------------------------

def _per_channel(want, got):
    return [_rel(want[..., c], got[..., c]) for c in range(want.shape[-1])]


@pytest.mark.cuda
@pytest.mark.parametrize("dims", LEVEL_DIMS)
def test_k1_coarse_on_card(cuda_device, dims):
    """K1's coarse instantiation on a level's block against the float64
    plain coarse residual, channel by channel: within 2e-5 of the
    channel's scale, or within twice what the plain float32 version comes
    to (float32's rounding of the SA rows at the wall sets it); two
    launches bitwise equal."""
    t32, consts = _operands(dims, cuda_device, torch.float32)
    c = _coarse_consts(consts)
    before = cuda_rans.LAUNCHES
    got = cuda_rans.fused_rans_residual(*t32, *c, coarse=True)
    again = cuda_rans.fused_rans_residual(*t32, *c, coarse=True)
    torch.cuda.synchronize()
    assert cuda_rans.LAUNCHES == before + 2
    assert torch.equal(got, again)
    want = cuda_rans.rans_residual_reference(
        *[t.double() for t in t32], *c, coarse=True)
    plain32 = cuda_rans.rans_residual_reference(*t32, *c, coarse=True)
    for e, p in zip(_per_channel(want, got), _per_channel(want, plain32)):
        assert e < max(2e-5, 2.0 * p), (e, p)


@pytest.mark.cuda
@pytest.mark.parametrize("dims", LEVEL_DIMS)
def test_smoothing_kernel_on_card(cuda_device, dims):
    """Three launches a call, within 1e-6 of each channel's scale of the
    float64 plain smoothing (the sweeps are diagonally dominant: float32
    rounds each value a few times)."""
    gen = torch.Generator(device=cuda_device).manual_seed(11)
    r = torch.randn(dims + (6,), generator=gen, device=cuda_device)
    assert smoothers._irs_kernel_applies(r)
    before = cuda_irs.LAUNCHES
    got = smoothers.residual_averaging(r, 0.5)
    torch.cuda.synchronize()
    assert cuda_irs.LAUNCHES == before + 3
    want = smoothers.plain_residual_averaging(r.double(), 0.5)
    assert max(_per_channel(want, got)) < 1e-6


@pytest.mark.cuda
def test_smoothing_dispatch_on_card(cuda_device):
    """Recorded by autograd or under ``torch.func.jvp`` the smoothing runs
    the plain sweeps (the kernel has no derivative rule)."""
    r = torch.randn((8, 6, 5, 6), device=cuda_device)
    assert smoothers._irs_kernel_applies(r)
    assert not smoothers._irs_kernel_applies(r.double())
    assert not smoothers._irs_kernel_applies(r.clone().requires_grad_())
    before = cuda_irs.LAUNCHES
    out, tan = torch.func.jvp(lambda a: smoothers.residual_averaging(a, 0.5),
                              (r,), (torch.ones_like(r),))
    assert cuda_irs.LAUNCHES == before
    torch.testing.assert_close(out, smoothers.residual_averaging(r, 0.5),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.cuda
def test_no_synchronising_copy_under_the_smoothing(cuda_device):
    """Once a line length's factors are on the card, a smoothing makes no
    copy that syncs the card."""
    import warnings

    r = torch.randn((16, 8, 8, 6), device=cuda_device)
    smoothers.residual_averaging(r, 0.5)
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            smoothers.residual_averaging(r, 0.5)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    assert [str(x.message) for x in caught
            if "called a synchronizing" in str(x.message)] == []
