"""Port parity: halo fill and the RANS-SA residual in float64 on the CPU.

The same numpy state (made from a seed) goes through the JAX package and
the port: ``fill_halos`` to 1e-14, the plain residual against the JAX
package's ``_jnp_reference`` (ops/pallas_rans.py:605) to 1e-12 relative per
channel, the full ``residual_list`` of the ``__graft_entry__.py`` wing
configuration (64x24x16) to 1e-12, and free-stream preservation below
1e-12 on a perturbed cube.
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adflow_tpu.core.refstate import AeroProblem as JaxAP
from adflow_tpu.core.refstate import make_reference_state as jax_refstate
from adflow_tpu.geom.metrics import compute_metrics_conn as jax_metrics
from adflow_tpu.geom.walldist import compute_wall_distances as jax_walldist
from adflow_tpu.meshgen.analytic import wing_omesh as jax_wing
from adflow_tpu.ops.pallas_rans import _jnp_reference
from adflow_tpu.physics import residual as jax_res
from adflow_torch.api.solver import ADFLOW
from adflow_torch.core.refstate import AeroProblem
from adflow_torch.geom.metrics import compute_metrics_conn
from adflow_torch.geom.walldist import compute_wall_distances
from adflow_torch.interop import (
    metrics_from_numpy, refstate_from_dict, state_from_numpy)
from adflow_torch.meshgen.analytic import cube_mesh, wing_omesh
from adflow_torch.ops import cuda_inviscid
from adflow_torch.ops.cuda_rans import rans_residual_reference
from adflow_torch.physics import residual as torch_res

F64 = torch.float64


def _per_channel_rel(a, b):
    a = np.asarray(a)
    b = b.detach().cpu().numpy()
    assert a.shape == b.shape
    return [float(np.abs(a[..., c] - b[..., c]).max()
                  / (np.abs(a[..., c]).max() + 1e-300))
            for c in range(a.shape[-1])]


def _problem(ni, nj, nk, ap_kwargs, seed, amp=0.03):
    """Both packages' wing problem and a perturbed padded state."""
    mesh_j = jax_wing(ni=ni, nj=nj, nk=nk, viscous=True)
    mesh_t = wing_omesh(ni=ni, nj=nj, nk=nk, viscous=True)
    ref_j = jax_refstate(JaxAP(**ap_kwargs), lift_index=2, n_turb=1)
    ref_t = refstate_from_dict(dataclasses.asdict(ref_j))
    xj = [jnp.asarray(b.x, jnp.float64) for b in mesh_j.blocks]
    xt = [torch.as_tensor(b.x, dtype=F64) for b in mesh_t.blocks]
    rng = np.random.RandomState(seed)
    shp = (ni + 4, nj + 4, nk + 4, 6)
    w = np.broadcast_to(ref_j.winf(), shp).copy()
    w *= 1.0 + amp * rng.randn(*shp)
    w[..., 5] = np.abs(w[..., 5])
    return dict(mesh_j=mesh_j, mesh_t=mesh_t, ref_j=ref_j, ref_t=ref_t,
                xj=xj, xt=xt, w=w)


CFG = dict(equation_type="rans", vis2=0.25, vis4=1.0 / 64.0,
           diss_exponent=0.67, turbulence_model="sa", turb_res_scale=1e4)


def test_fill_halos_match():
    pb = _problem(24, 12, 8, dict(name="w", mach=0.8, alpha=1.5,
                                  reynolds=1e6), seed=1)
    mj = jax_metrics(pb["mesh_j"].blocks, pb["xj"])
    mt = compute_metrics_conn(pb["mesh_t"].blocks, pb["xt"])
    topo_j = jax_res.build_topology(pb["mesh_j"])
    topo_t = torch_res.build_topology(pb["mesh_t"])
    winf = pb["ref_j"].winf()
    wj = jax_res.fill_halos([jnp.asarray(pb["w"])], mj, topo_j, pb["ref_j"],
                            jnp.asarray(winf))
    wt = torch_res.fill_halos(state_from_numpy([pb["w"]]), mt, topo_t,
                              pb["ref_t"], torch.as_tensor(winf))
    a, b = np.asarray(wj[0]), wt[0].numpy()
    # relative to the largest state entry: the far-field inflow/outflow
    # blend divides the normal velocity by 0.01 c (bc.py
    # FARFIELD_BLEND_WIDTH), which lifts last-bit differences of the two
    # packages' math libraries in corner ghosts to ~1e-14 of a channel
    assert np.abs(a - b).max() <= 1e-14 * np.abs(a).max()
    # every ghost the fill writes differs from the unfilled input
    assert np.abs(b - pb["w"]).max() > 0.0


def test_plain_residual_matches_jnp_reference():
    """The test_pallas_rans.py setup (24x12x8 wing, 3% noise), in f64."""
    pb = _problem(24, 12, 8, dict(name="w", mach=0.8, alpha=1.5,
                                  reynolds=1e6), seed=0)
    from adflow_tpu.geom.metrics import compute_metrics
    m = compute_metrics(pb["xj"][0])
    d = jax_walldist(pb["mesh_j"], pb["xj"], jnp.float64)[0]
    por = jax_res.build_topology(pb["mesh_j"]).blocks[0].por
    arrays = [pb["w"], m.siE, m.sjE, m.skE, m.vol, m.xc_ext, d, *por]
    consts = (0.25, 1.0 / 64.0, 0.67, pb["ref_j"].mu_inf,
              pb["ref_j"].t_inf_dim, True, 1e4)
    want = jax.jit(lambda *a: _jnp_reference(*a, *consts))(
        *(jnp.asarray(a) for a in arrays))
    got = rans_residual_reference(*state_from_numpy(arrays), *consts)
    errs = _per_channel_rel(want, got)
    assert max(errs) < 1e-12, errs


def test_graft_entry_wing_residual_matches():
    """residual_list on the __graft_entry__.py flagship (64x24x16 wing,
    M0.8, alpha 1.5, Re 1e6, turbResScale 1e4), perturbed state."""
    pb = _problem(64, 24, 16, dict(name="wing", mach=0.8, alpha=1.5,
                                   reynolds=1e6, areaRef=2.7, chordRef=0.9),
                  seed=2, amp=0.01)
    cfg_j = jax_res.ProblemConfig(**CFG)
    cfg_t = torch_res.ProblemConfig(**CFG)
    blocks = pb["mesh_j"].blocks
    mj = jax.jit(lambda x: jax_metrics(blocks, [x]))(pb["xj"][0])
    dj = jax_walldist(pb["mesh_j"], pb["xj"], jnp.float64)
    # the port's own metrics and wall distance, checked against the JAX
    # package's in test_torch_geometry.py; here both feed their own chain
    mt = [metrics_from_numpy(*(np.asarray(getattr(m, f)) for f in
                               ("siE", "sjE", "skE", "vol", "xc_ext")))
          for m in mj]
    dt = compute_wall_distances(pb["mesh_t"], pb["xt"])
    winf = pb["ref_j"].winf()
    topo_j = jax_res.build_topology(pb["mesh_j"])
    rj = jax.jit(lambda w, d: jax_res.residual_list(
        [w], mj, topo_j, cfg_j, pb["ref_j"], jnp.asarray(winf),
        [{"walldist": d}]))(jnp.asarray(pb["w"]), dj[0])
    rt = torch_res.residual_list(
        state_from_numpy([pb["w"]]), mt,
        torch_res.build_topology(pb["mesh_t"]), cfg_t, pb["ref_t"],
        torch.as_tensor(winf), [{"walldist": dt[0]}])
    errs = _per_channel_rel(rj[0], rt[0])
    assert max(errs) < 1e-12, errs


def test_freestream_preserved_on_perturbed_cube():
    mesh = cube_mesh(n=6, perturb=0.2, seed=2)
    solver = ADFLOW(options={"equationType": "RANS", "useANKSolver": False,
                             "printIterations": False,
                             "printTiming": False},
                    mesh=mesh, device="cpu")
    ap = AeroProblem(name="fs", mach=0.3, alpha=2.0, reynolds=1e6)
    r = solver.getResidual(ap)
    assert solver.dtype == torch.float64
    assert max(float(torch.max(torch.abs(x))) for x in r) < 1e-12


@pytest.mark.parametrize("dtype,use_kernels,expect", [
    (torch.float32, True, False),     # CPU tensor: plain version
    (torch.float64, True, False),
    (torch.float32, False, False),
])
def test_kernel_routing_on_cpu(dtype, use_kernels, expect):
    """block_residual sends only CUDA f32 tensors to the kernel
    (adflow_tpu/physics/residual.py:217-227 plus w.is_cuda)."""
    cfg = torch_res.ProblemConfig(**CFG, use_kernels=use_kernels)
    w = torch.zeros((5, 5, 5, 6), dtype=dtype)
    m = metrics_from_numpy(*(np.zeros(1),) * 5)
    extras = {"walldist": torch.zeros(1)}
    assert torch_res._kernel_applies(w, m, cfg, extras, (w,) * 3) is expect


@pytest.mark.parametrize("dims,expect", [
    ((256, 64, 64), 1),                # the main path's wing
    ((1020, 1020, 405), 1),            # 5 x 1024 x 1024 x 409 < 2^31 - 1
    ((1020, 1020, 406), 2),            # one plane more passes 2^31 - 1
    ((4, 20000, 20000), None),         # one padded plane alone passes it
])
def test_inviscid_kernel_routing_respects_32bit_offsets(dims, expect):
    """K2's launch refuses a padded w5 of more than 2^31 - 1 floats (its
    32-bit offsets), so a larger block on the card still routes to K2, which
    covers it in slabs of i-planes that each fit, one launch each; a block
    whose single plane is past the limit raises. A stand-in CUDA tensor: no
    such array is allocated."""
    cfg = torch_res.ProblemConfig(**CFG, use_kernels=True)
    w = types.SimpleNamespace(dtype=torch.float32, is_cuda=True,
                              shape=tuple(n + 4 for n in dims) + (5,))
    m = metrics_from_numpy(*(np.zeros(1),) * 5)
    assert torch_res._inviscid_kernel_applies(w, m, cfg, (None,) * 3)
    ni, nj, nk = dims
    if expect is None:
        with pytest.raises(ValueError, match="32-bit offsets"):
            cuda_inviscid.k2_slabs(*dims)
        return
    slabs = cuda_inviscid.k2_slabs(*dims)
    assert len(slabs) == expect
    assert [i0 for i0, _ in slabs] == list(
        np.cumsum([0] + [n for _, n in slabs[:-1]]))
    assert sum(n for _, n in slabs) == ni
    assert all(5 * (n + 4) * (nj + 4) * (nk + 4) <= 2**31 - 1
               for _, n in slabs)
