"""What the drivers share on the program's side: the system under test,
``adflow_torch.ADFLOW``, built from a configuration's file with the mesh of
the benchmark's own generator, and the seeded start. The program is
imported here only, when a driver's set-up runs."""

from __future__ import annotations

import importlib
from types import SimpleNamespace

import torch

from benchmark import harness, wing

# the configuration file's keys that are not solver options
NOT_OPTIONS = ("name", "source", "assumed", "reduced", "chip", "mesh",
               "conditions")


def options(config: dict) -> dict:
    return {k: v for k, v in config.items() if k not in NOT_OPTIONS}


def mesh_spec(config: dict, dims=None) -> dict:
    """The configuration's mesh as plain data (``dims``, for the CPU
    tests, replaces its cell counts)."""
    m = dict(config["mesh"])
    if m.pop("generator") != "wing_spec":
        raise ValueError("the benchmark's generator is wing_spec")
    if dims is not None:
        m.update(ni=dims[0], nj=dims[1], nk=dims[2])
    return wing.wing_spec(**m)


def launches(counter: str) -> int:
    """The launch count of the kernel module ``adflow_torch.ops.<counter>``
    (its ``LAUNCHES``)."""
    return importlib.import_module(f"adflow_torch.ops.{counter}").LAUNCHES


def build(ctx) -> SimpleNamespace:
    """``ADFLOW`` on the configuration's mesh and options, its aero problem
    set, and the seeded start (float64 numpy and in the solver's dtype)."""
    from adflow_torch import ADFLOW, AeroProblem
    from adflow_torch.core import mesh as pmesh

    config = ctx.cell.config
    spec = mesh_spec(config, ctx.mesh_dims)
    solver = ADFLOW(options=options(config),
                    mesh=wing.build_mesh(spec, pmesh), device=ctx.device)
    ap = AeroProblem(**config["conditions"])
    solver.setAeroProblem(ap)
    start = harness.seeded_start(
        solver.getStates().double().cpu().numpy(), solver.ref.nw, ctx.seed,
        float(ctx.cell.traffic["start"]["perturbation"]))
    return SimpleNamespace(
        solver=solver, ap=ap, spec=spec, start64=start,
        start=torch.as_tensor(start, dtype=solver.dtype,
                              device=solver.device),
        counter=ctx.cell.traffic["launches"]["counter"])


def newton_pieces(st):
    """The ANK step's pieces at the solver's current state and the CFL of
    the window's last step: (matvec, PC apply, a unit vector), rebuilt
    here from the program's functions as ``solve_newton_driver`` builds
    them. Kept on ``st``. The readers that time these time the
    benchmark's rebuilt operator: a change inside the driver's own step
    (a CUDA graph of its matvec, say) does not reach them."""
    if getattr(st, "_newton", None) is None:
        from adflow_torch.solvers import newton
        s = st.solver
        fns = newton.build_newton_fns(s.w_list, s.metrics_list, s.topo,
                                      s.cfg, s.ref, s.winf, s.extras_list)
        wvec = fns.packer.pack_w(s.w_list)
        cfl = s.solve_info.steps[-1].cfl
        axes, kappa = newton._pc_params(s.options)
        pc = fns.build_pc(wvec, cfl, axes=axes, kappa=kappa)
        _, rs_list = fns.rad_sum_cells(wvec)
        diag = fns.packer.pack([(rs / cfl)[..., None].expand(
            rs.shape + (fns.packer.nw,)) for rs in rs_list])
        r = fns.res_flat(wvec)
        v = r / torch.linalg.norm(r)

        def matvec(u):
            return diag * u + torch.func.jvp(fns.res_flat, (wvec,), (u,))[1]

        def precond(u):
            return newton.pc_apply_vec(pc, fns.packer, u)

        st._newton = (matvec, precond, v)
    return st._newton


def adjoint_pieces(st, seed: int):
    """The adjoint's pieces at the solver's state: (one vjp matvec, the
    transposed PC apply, a seeded random vector), rebuilt here from the
    program's functions as ``solve_adjoint_system`` builds them. Kept on
    ``st``; as with ``newton_pieces``, a change inside the adjoint solve's
    own loop does not reach them."""
    if getattr(st, "_adjoint", None) is None:
        from adflow_torch.adjoint import api as adj
        s = st.solver
        fns = s._adjoint_fns()
        wvec, xvec = s._wx_vecs()
        params = s._ap_params(st.ap)
        _, vjp_w = torch.func.vjp(lambda w: fns.res(w, xvec, params), wvec)
        precond = adj._transposed_line_pc(s._newton_fns(), wvec)
        gen = torch.Generator(device=wvec.device).manual_seed(
            seed % (1 << 63))
        v = torch.randn(wvec.shape, generator=gen, device=wvec.device,
                        dtype=wvec.dtype)
        st._adjoint = (lambda u: vjp_w(u)[0], precond, v)
    return st._adjoint
