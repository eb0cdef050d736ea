"""OpenMDAO / MPhys integration layer.

Reference analogue: ``adflow/mphys/mphys_adflow.py`` (1,572 LoC):
``ADflowMesh:227`` (mesh source component), ``ADflowSolver:416`` (implicit
component — apply_nonlinear = residual, solve_nonlinear = solve,
apply_linear = JVP/VJP), ``ADflowForces:715``, ``ADflowFunctions:965``,
``ADflowBuilder:1332``.

Design: the framework-agnostic coupling contract lives in
``ImplicitCFDAdapter`` (usable from any MDO framework or optimizer); thin
OpenMDAO component wrappers are defined only when openmdao is importable
(tests drive them through a stub of its API, tests/miniom.py).

The solver's states, coordinates and residuals are tensors on its device;
the adapter and the components hand numpy arrays across the coupling
boundary, as OpenMDAO expects, and the solver's entry points take numpy
arrays back (``setStates``, ``setGrid``, the Jacobian-vector products).
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np

from adflow_torch.api.output import to_numpy as _numpy


def _flat_coords(solver) -> np.ndarray:
    return np.concatenate([_numpy(x).reshape(-1) for x in solver.x_list])


class ImplicitCFDAdapter:
    """Framework-agnostic implicit-analysis view of the solver.

    States u = flattened interior conservative variables; inputs
    x = flattened volume node coordinates + aero parameters (alpha, beta,
    mach). Exposes exactly the contract MPhys needs (mphys_adflow.py
    ADflowSolver): residual(u, x), solve(x), and the four linear products.
    """

    def __init__(self, solver, ap):
        self.solver = solver
        self.ap = ap
        solver.setAeroProblem(ap)

    # -- nonlinear -------------------------------------------------------
    def get_states(self) -> np.ndarray:
        return _numpy(self.solver.getStates())

    def set_states(self, u: np.ndarray) -> None:
        self.solver.setStates(u)

    def get_coords(self) -> np.ndarray:
        return _flat_coords(self.solver)

    def apply_nonlinear(self) -> np.ndarray:
        """Residual at the current (u, x)."""
        r = self.solver.getResidual(self.ap)
        return np.concatenate([_numpy(b).reshape(-1) for b in r])

    def solve_nonlinear(self) -> np.ndarray:
        self.solver(self.ap)
        return self.get_states()

    def eval_functions(self, names: Sequence[str]) -> Dict[str, float]:
        funcs: Dict[str, float] = {}
        self.solver.evalFunctions(self.ap, funcs, evalFuncs=names)
        return {n: funcs[f"{self.ap.name}_{n}"] for n in names}

    # -- linear (exact JVP/VJP by torch.func) ----------------------------
    def apply_linear_fwd(self, wDot=None, xVDot=None):
        return self.solver.computeJacobianVectorProductFwd(
            wDot=wDot, xVDot=xVDot, residualDeriv=True)

    def apply_linear_rev(self, resBar):
        return self.solver.computeJacobianVectorProductBwd(
            resBar=resBar, wDeriv=True, xVDeriv=True)

    def solve_linear_rev(self, dIdw: np.ndarray, objective: str):
        """Adjoint solve for one objective (MPhys solve_linear)."""
        return _numpy(self.solver.solveAdjoint(self.ap, objective))

    def eval_function_sens(self, names: Sequence[str]):
        sens: Dict[str, dict] = {}
        self.solver.evalFunctionsSens(self.ap, sens, evalFuncs=names)
        return {n: sens[f"{self.ap.name}_{n}"] for n in names}


def _require_openmdao():
    try:
        import openmdao.api as om  # noqa: F401
        return om
    except ImportError as e:  # pragma: no cover - om not in this image
        raise ImportError(
            "openmdao is required for the MPhys components; the "
            "framework-agnostic ImplicitCFDAdapter works without it"
        ) from e


class ADflowBuilder:
    """MPhys-style builder (mphys_adflow.py:1332): constructs the solver
    once per MPI-like context and hands out coupling components."""

    def __init__(self, options: dict, mesh=None, device=None):
        self.options = options
        self.mesh = mesh
        self.device = device       # None: the solver's default, cuda:0
        self.solver = None

    def initialize(self, comm=None):
        from adflow_torch.api.solver import ADFLOW
        self.solver = ADFLOW(options=self.options, mesh=self.mesh,
                             comm=comm, device=self.device)

    def get_solver(self):
        return self.solver

    def get_number_of_nodes(self) -> int:
        return sum(int(np.prod(x.shape[:3]))
                   for x in self.solver.x_list)

    def get_coupling_group_subsystem(self, scenario_name=None):
        """The implicit CFD component class (mphys_adflow.ADflowSolver:416
        analogue)."""
        om = _require_openmdao()
        return _make_solver_comp(om, self)

    def get_mesh_coordinate_subsystem(self, scenario_name=None):
        """Mesh-source component (mphys_adflow.ADflowMesh:227)."""
        om = _require_openmdao()
        return _make_mesh_comp(om, self)

    def get_post_coupling_subsystem(self, scenario_name=None):
        """Function-evaluation component (mphys_adflow.ADflowFunctions:965)."""
        om = _require_openmdao()
        return _make_functions_comp(om, self)

    def get_forces_subsystem(self, scenario_name=None):
        """Nodal-force component (mphys_adflow.ADflowForces:715)."""
        om = _require_openmdao()
        return _make_forces_comp(om, self)


def _make_solver_comp(om, builder):
    class ADflowSolverComp(om.ImplicitComponent):
        """mphys_adflow.ADflowSolver:416 analogue: apply_nonlinear =
        residual, solve_nonlinear = full solve, apply_linear = exact
        JVP/VJP, solve_linear = preconditioned adjoint GMRES."""

        def initialize(self):
            self.options.declare("ap")

        def setup(self):
            self.adapter = ImplicitCFDAdapter(
                builder.solver, self.options["ap"])
            n = self.adapter.get_states().size
            nx = self.adapter.get_coords().size
            self.add_input("adflow_vol_coords", shape=nx,
                           val=self.adapter.get_coords())
            self.add_output("adflow_states", shape=n,
                            val=self.adapter.get_states())

        def _sync(self, inputs, outputs):
            self.adapter.solver.setGrid(
                np.asarray(inputs["adflow_vol_coords"]))
            self.adapter.set_states(np.asarray(outputs["adflow_states"]))

        def apply_nonlinear(self, inputs, outputs, residuals):
            self._sync(inputs, outputs)
            residuals["adflow_states"] = self.adapter.apply_nonlinear()

        def solve_nonlinear(self, inputs, outputs):
            outputs["adflow_states"] = self.adapter.solve_nonlinear()

        def apply_linear(self, inputs, outputs, d_inputs, d_outputs,
                         d_residuals, mode):
            if mode == "fwd":
                d_residuals["adflow_states"] = (
                    d_residuals["adflow_states"]
                    + self.adapter.apply_linear_fwd(
                        wDot=d_outputs.get("adflow_states"),
                        xVDot=d_inputs.get("adflow_vol_coords")))
            else:
                gw, gx = self.adapter.apply_linear_rev(
                    np.asarray(d_residuals["adflow_states"]))
                if "adflow_states" in d_outputs:
                    d_outputs["adflow_states"] = (
                        d_outputs["adflow_states"] + np.asarray(gw))
                if "adflow_vol_coords" in d_inputs:
                    d_inputs["adflow_vol_coords"] = (
                        d_inputs["adflow_vol_coords"] + np.asarray(gx))

    return ADflowSolverComp


def _make_mesh_comp(om, builder):
    class ADflowMeshComp(om.ExplicitComponent):
        """mphys_adflow.ADflowMesh:227 analogue: sources the initial
        volume coordinates (`adflow_vol_coords` / x_aero0)."""

        def setup(self):
            coords = _flat_coords(builder.solver)
            self.add_output("adflow_vol_coords", shape=coords.size,
                            val=coords)

        def compute(self, inputs, outputs):
            outputs["adflow_vol_coords"] = _flat_coords(builder.solver)

    return ADflowMeshComp


def _make_functions_comp(om, builder):
    class ADflowFunctionsComp(om.ExplicitComponent):
        """mphys_adflow.ADflowFunctions:965 analogue: cost functions of
        (states, coords) with exact reverse-mode derivatives."""

        def initialize(self):
            self.options.declare("ap")

        def setup(self):
            self.adapter = ImplicitCFDAdapter(
                builder.solver, self.options["ap"])
            ap = self.options["ap"]
            n = self.adapter.get_states().size
            nx = self.adapter.get_coords().size
            self.add_input("adflow_states", shape=n,
                           val=self.adapter.get_states())
            self.add_input("adflow_vol_coords", shape=nx,
                           val=self.adapter.get_coords())
            self._funcs = list(ap.evalFuncs)
            for f in self._funcs:
                self.add_output(f, shape=1)

        def compute(self, inputs, outputs):
            self.adapter.solver.setGrid(
                np.asarray(inputs["adflow_vol_coords"]))
            self.adapter.set_states(np.asarray(inputs["adflow_states"]))
            vals = self.adapter.eval_functions(self._funcs)
            for f in self._funcs:
                outputs[f] = vals[f]

        def compute_jacvec_product(self, inputs, d_inputs, d_outputs,
                                   mode):
            solver = self.adapter.solver
            if mode == "fwd":
                out = solver.computeJacobianVectorProductFwd(
                    wDot=d_inputs.get("adflow_states"),
                    xVDot=d_inputs.get("adflow_vol_coords"),
                    funcDeriv=True)
                for f in self._funcs:
                    if f in d_outputs:
                        d_outputs[f] = d_outputs[f] + out[f.lower()]
            else:
                funcsBar = {f.lower(): float(np.ravel(d_outputs[f])[0])
                            for f in self._funcs if f in d_outputs}
                gw, gx = solver.computeJacobianVectorProductBwd(
                    funcsBar=funcsBar, wDeriv=True, xVDeriv=True)
                if "adflow_states" in d_inputs:
                    d_inputs["adflow_states"] = (
                        d_inputs["adflow_states"] + np.asarray(gw))
                if "adflow_vol_coords" in d_inputs:
                    d_inputs["adflow_vol_coords"] = (
                        d_inputs["adflow_vol_coords"] + np.asarray(gx))

    return ADflowFunctionsComp


def _make_forces_comp(om, builder):
    class ADflowForcesComp(om.ExplicitComponent):
        """mphys_adflow.ADflowForces:715 analogue: nodal surface forces
        of (states, coords) — the load-transfer source for
        aerostructural coupling."""

        def initialize(self):
            self.options.declare("ap")

        def setup(self):
            self.adapter = ImplicitCFDAdapter(
                builder.solver, self.options["ap"])
            n = self.adapter.get_states().size
            nx = self.adapter.get_coords().size
            self.add_input("adflow_states", shape=n,
                           val=self.adapter.get_states())
            self.add_input("adflow_vol_coords", shape=nx,
                           val=self.adapter.get_coords())
            nf = np.asarray(builder.solver.getForces()).size
            self.add_output("f_aero", shape=nf)

        def compute(self, inputs, outputs):
            self.adapter.solver.setGrid(
                np.asarray(inputs["adflow_vol_coords"]))
            self.adapter.set_states(np.asarray(inputs["adflow_states"]))
            outputs["f_aero"] = np.asarray(
                builder.solver.getForces()).reshape(-1)

    return ADflowForcesComp
