"""The benchmark's plain reference: the residual, the RK cycle, the ANK
step's linear system, the functions cl and cd and the adjoint's pieces of
one configuration, in plain PyTorch.

The modules here are frozen copies of adflow_torch's plain metrics, JST
residual, boundary conditions, SA model, viscous flux, wall distance and
force integration, with their imports made local, so that the yardstick
does not move when the program does. This package imports nothing of the
program, of JAX or of the JAX package. It is given the coordinates and the
flow conditions and works out the metrics, the halo and boundary
topology, the free stream and the wall distance itself; it takes the
program's states and outputs only to judge them.

``dtype`` is the precision the reference computes in: float64 for the
reference itself, bfloat16 for the control. The metrics and the wall
distance are always worked out in float64 from the coordinates and then
rounded to ``dtype`` (the coordinates themselves do not survive bfloat16:
the wing's cells near the wall would collapse).
"""

from __future__ import annotations

import dataclasses
import math

import torch

from .metrics import BlockMetrics, compute_metrics_conn
from .refstate import AeroProblem, make_reference_state
from .residual import ProblemConfig, build_topology, fill_halos, residual_list
from .surface import build_wall_patches, cost_functions, integrate_forces

# float32 matrix products in full precision: the wall distance ranks its
# candidates by a matrix product
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def _cast_metrics(m: BlockMetrics, dtype) -> BlockMetrics:
    return BlockMetrics(*(None if t is None else t.to(dtype) for t in m))


def problem_config(options: dict) -> ProblemConfig:
    """The residual's discretization from a configuration's options (the
    program's defaults where the configuration leaves one out)."""
    eq = str(options.get("equationType", "RANS")).lower()
    trs = options.get("turbResScale")
    if trs is None:
        trs = 1e4 if eq == "rans" else 1.0
    model = str(options.get("turbulenceModel", "SA")).lower()
    if eq == "rans" and model != "sa":
        raise NotImplementedError(f"turbulence model {model!r}")
    if str(options.get("discretization", "central plus scalar dissipation")
           ).lower() != "central plus scalar dissipation":
        raise NotImplementedError("only the central JST discretization")
    return ProblemConfig(
        equation_type=eq,
        vis2=float(options.get("vis2", 0.25)),
        vis4=float(options.get("vis4", 0.0156)),
        diss_exponent=float(options.get("dissipationScalingExponent", 0.67)),
        turb_order=str(options.get("turbulenceOrder", "first order")),
        turb_res_scale=float(trs),
        use_ft2=bool(options.get("useft2SA", True)))


class Reference:
    """The reference of one configuration on one mesh.

    ``mesh``: a ``reference.mesh.MultiBlockMesh``; ``conditions``: the
    aero problem's keywords; ``options``: the configuration's solver
    options. Flat state vectors are laid out as the program's
    ``getStates``: each block's interior (ni, nj, nk, nw), row-major, one
    block after another."""

    def __init__(self, mesh, conditions: dict, options: dict,
                 dtype=torch.float64, device="cpu"):
        self.mesh = mesh
        self.dtype = dtype
        self.device = torch.device(device)
        self.cfg = problem_config(options)
        self.ap = AeroProblem(**conditions)
        self.ref = make_reference_state(
            self.ap, lift_index=int(options.get("liftIndex", 2)),
            n_turb=self.cfg.n_turb,
            eddy_vis_inf_ratio=float(options.get("eddyVisInfRatio", 0.009)))
        self.nw = self.ref.nw
        self.winf = torch.as_tensor(self.ref.winf(), dtype=dtype,
                                    device=self.device)
        f64 = dict(dtype=torch.float64, device=self.device)
        self.x_list = [torch.as_tensor(b.x, **f64) for b in mesh.blocks]
        self.topo = build_topology(mesh, dtype=dtype, device=self.device)
        self.metrics_list = [_cast_metrics(m, dtype) for m in
                             compute_metrics_conn(mesh.blocks, self.x_list)]
        self.wall_patches = build_wall_patches(mesh)
        self.extras_list = None
        if self.cfg.rans:
            from .walldist import compute_wall_distances
            d_list = compute_wall_distances(
                mesh, self.x_list,
                cutoff=float(options.get("wallDistCutoff", 1e20)))
            self.extras_list = [{"walldist": d.to(dtype)} for d in d_list]
        self.dims = [b.dims for b in mesh.blocks]
        self.sizes = [math.prod(d) * self.nw for d in self.dims]
        self.n = sum(self.sizes)

    # -- flat vectors -------------------------------------------------------
    def as_vec(self, v) -> torch.Tensor:
        """A flat vector of the program's, in the reference's precision."""
        t = v if torch.is_tensor(v) else torch.as_tensor(v)
        return t.detach().to(device=self.device, dtype=self.dtype
                             ).reshape(-1)

    def unpack(self, vec):
        out, ofs = [], 0
        for d, n in zip(self.dims, self.sizes):
            out.append(vec[ofs:ofs + n].reshape(tuple(d) + (self.nw,)))
            ofs += n
        return out

    def pack(self, arr_list):
        return torch.cat([a.reshape(-1) for a in arr_list])

    def padded(self, vec, winf=None):
        """Halo-padded states: the interiors of ``vec`` in a free-stream
        template."""
        winf = self.winf if winf is None else winf
        out = []
        for d, interior in zip(self.dims, self.unpack(vec)):
            w = winf.expand(tuple(s + 4 for s in d) + (self.nw,)).clone()
            w[2:-2, 2:-2, 2:-2] = interior
            out.append(w)
        return out

    # -- the residual and what the solvers report ---------------------------
    def residual(self, vec):
        """R(w), flat, with the turbulence rows scaled as the program's."""
        r = residual_list(self.padded(vec), self.metrics_list, self.topo,
                          self.cfg, self.ref, self.winf, self.extras_list)
        return self.pack(r)

    def norms(self, vec):
        """(||R||, ||R_meanflow||, ||R_turb||) at ``vec``, as floats."""
        r = self.residual(self.as_vec(vec)).reshape(-1, self.nw)
        return (float(torch.linalg.norm(r.double())),
                float(torch.linalg.norm(r[:, :5].double())),
                float(torch.linalg.norm(r[:, 5:].double())))

    def ank_diagonal(self, vec, cfl):
        """The pseudo-time diagonal V/dt of the ANK step at CFL ``cfl``:
        the cells' summed spectral radii (viscous ones times 4) over the
        CFL, times the turbulence rows' scale."""
        from .fluxes import spectral_radii
        from .thermo import pressure
        from .timestep import viscous_spectral_radii
        wf = fill_halos(self.padded(vec), self.metrics_list, self.topo,
                        self.ref, self.winf)
        chan = torch.ones((self.nw,), dtype=self.dtype, device=self.device)
        if self.cfg.rans:
            chan[5:] = self.cfg.turb_res_scale
        outs = []
        for w, m in zip(wf, self.metrics_list):
            p = torch.clamp(pressure(w), min=1e-10)
            rI, rJ, rK = spectral_radii(w, p, m, 0.0)
            rs = (rI + rJ + rK)[1:-1, 1:-1, 1:-1]
            if self.cfg.viscous:
                rv = viscous_spectral_radii(w, m, self.cfg, self.ref)
                rs = rs + 4.0 * (rv[0] + rv[1] + rv[2])
            outs.append((rs / cfl)[..., None] * chan)
        return self.pack(outs)

    def ank_linear_residual(self, w_before, w_after, alpha, cfl):
        """||(D + J) dx + R|| / ||R|| at ``w_before``, dx the step's
        direction (w_after - w_before) / alpha: the linear residual of the
        ANK step's Newton system for the update the program took."""
        w0 = self.as_vec(w_before)
        dx = (self.as_vec(w_after) - w0) / alpha
        r, jdx = torch.func.jvp(self.residual, (w0,), (dx,))
        lin = self.ank_diagonal(w0, cfl) * dx + jdx + r
        return float(torch.linalg.norm(lin.double())
                     / torch.linalg.norm(r.double()))

    def rk_cycles(self, vec, n_cycles, cfl):
        """``n_cycles`` RK cycles from ``vec``: the final flat state and
        the (mean-flow, turbulence) norms of each cycle's first-stage
        residual, as the program's RK driver reports them."""
        from .rk import residual_norms, rk_iteration
        w_list = self.padded(self.as_vec(vec))
        hist = []
        for _ in range(n_cycles):
            w_list, r_list = rk_iteration(
                w_list, self.metrics_list, self.topo, self.cfg, self.ref,
                self.winf, cfl, self.extras_list)
            hist.append(torch.stack(residual_norms(r_list)))
        vec = self.pack([w[2:-2, 2:-2, 2:-2] for w in w_list])
        return vec, torch.stack(hist).double().cpu().numpy()

    def functions(self, vec):
        """{cl, cd, ...} at ``vec`` as floats."""
        wf = fill_halos(self.padded(self.as_vec(vec)), self.metrics_list,
                        self.topo, self.ref, self.winf)
        xl = [x.to(self.dtype) for x in self.x_list]
        f = integrate_forces(wf, xl, self.metrics_list, self.wall_patches,
                             self.ref, self.cfg, extras_list=self.extras_list)
        return {k: float(v) for k, v in cost_functions(f, self.ref).items()
                if v.ndim == 0}

    # -- the adjoint --------------------------------------------------------
    def params(self):
        """The design variables of the totals, as 0-d float64 tensors."""
        ap = self.ap
        kw = dict(dtype=torch.float64, device=self.device)
        return {k: torch.tensor(v, **kw) for k, v in (
            ("alpha", ap.alpha), ("beta", ap.beta), ("mach", ap.mach),
            ("T", ap.T), ("P", ap.P))}

    def traced(self, vec, xvec, params):
        """(R, {functions}) as functions of the state, the node coordinates
        (flat, float64) and the design variables."""
        from .adjoint import traced_reference_state, traced_winf
        ref = traced_reference_state(self.ref, params)
        winf = traced_winf(ref).to(self.dtype)
        x_list, ofs = [], 0
        for x in self.x_list:
            x_list.append(xvec[ofs:ofs + x.numel()].reshape(x.shape))
            ofs += x.numel()
        metrics = [_cast_metrics(m, self.dtype) for m in
                   compute_metrics_conn(self.mesh.blocks, x_list)]
        ref = _cast_ref(ref, self.dtype)
        wp = self.padded(vec, winf)
        r = self.pack(residual_list(wp, metrics, self.topo, self.cfg, ref,
                                    winf, self.extras_list))
        wf = fill_halos(wp, metrics, self.topo, ref, winf)
        f = integrate_forces(wf, [x.to(self.dtype) for x in x_list], metrics,
                             self.wall_patches, ref, self.cfg,
                             extras_list=self.extras_list)
        return r, cost_functions(f, ref)

    def adjoint_check(self, vec, psi, key):
        """For the program's adjoint ``psi`` of function ``key`` at state
        ``vec``: the relative residual ||dR/dw^T psi - dI/dw|| / ||dI/dw||
        and the totals dI/d* = dI/d*|direct - psi^T dR/d* of alpha, mach and
        the node coordinates that the reference assembles with it."""
        w0 = self.as_vec(vec)
        psi = self.as_vec(psi)
        xvec = torch.cat([x.reshape(-1) for x in self.x_list])
        params = self.params()

        def res(w, x, p):
            return self.traced(w, x, p)[0]

        def func(w, x, p):
            return self.traced(w, x, p)[1][key]

        _, vjp = torch.func.vjp(res, w0, xvec, params)
        gR_w, gR_x, gR_p = vjp(psi)
        gI_w, gI_x, gI_p = torch.func.grad(func, argnums=(0, 1, 2))(
            w0, xvec, params)
        rel = float(torch.linalg.norm((gR_w - gI_w).double())
                    / torch.linalg.norm(gI_w.double()))
        tot = {k: float(gI_p[k] - gR_p[k]) for k in ("alpha", "mach")}
        tot["xv"] = (gI_x - gR_x).double()
        return rel, tot


def _cast_ref(ref, dtype):
    """The traced reference state with its tensors in ``dtype``."""
    return dataclasses.replace(ref, **{
        k: v.to(dtype) for k, v in vars(ref).items()
        if torch.is_tensor(v) and v.is_floating_point()})
