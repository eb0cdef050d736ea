"""Option system.

Mirrors the reference's single-options-dict design
(`ADflow: adflow/pyADflow.py:5632` `_getDefaultOptions`, schema in
`doc/options.yaml`, 266 options): user passes a ``{name: value}`` dict at
construction, names are case-insensitive, unknown names raise. Instead of the
reference's name->(Fortran module, variable) map (`pyADflow.py:5974`), options
are validated here and frozen into an immutable ``Options`` object consumed by
trace-time code. Everything that changes compiled code (discretization,
equation type, smoother...) is a static Python value; continuous parameters
(CFL, vis2, ...) flow into jitted functions as arrays where useful.
"""

from __future__ import annotations

import difflib
from types import MappingProxyType
from typing import Any, Dict


# ---------------------------------------------------------------------------
# Defaults. Names and default values follow the reference where the concept
# carries over (pyADflow.py:5632-5941); device-specific additions are grouped
# at the end. The defaults equal those of the JAX package (adflow_tpu/options.py)
# except ``useBlockettes``.
# ---------------------------------------------------------------------------
_DEFAULT_OPTIONS: Dict[str, Any] = {
    # I/O
    "gridFile": "default.cgns",
    "restartFile": None,
    "outputDirectory": "./",
    "solutionPrecision": "double",
    "gridPrecision": "double",
    "monitorVariables": ["cpu", "resrho", "resturb", "cl", "cd"],
    "surfaceVariables": ["cp", "vx", "vy", "vz", "mach"],
    "volumeVariables": ["resrho"],
    # {variable: value} isosurfaces written by writeIsoSurfaceFile
    # (reference: isoSurface option, outputMod.F90:68)
    "isoSurface": {},
    "numberSolutions": True,
    "printIterations": True,
    "printTiming": True,
    "printAllOptions": True,
    "writeSolutionDigits": 3,

    # Physics
    "equationType": "RANS",              # 'euler' | 'laminar NS' | 'RANS'
    "equationMode": "steady",            # 'steady' | 'unsteady' | 'time spectral'
    "flowType": "external",              # 'external' | 'internal'
    "turbulenceModel": "SA",             # 'SA' | 'SA-Edwards' | 'SST'
    "turbulenceOrder": "first order",
    "turbResScale": None,
    "useQCR": False,
    "useRotationSA": False,
    "useft2SA": True,
    "eddyVisInfRatio": 0.009,
    "useWallFunctions": False,
    "useApproxWallDistance": True,
    # constant ratio of specific heats (reference: gammaConstant option,
    # flowUtils.F90 computeGamma; the variable-gamma Cp curve fits of
    # CpCurveFits.f90 are out of scope — any non-1.4 value is rejected at
    # validation, not silently ignored)
    "gammaConstant": 1.4,
    "wallDistCutoff": 1e20,
    "lowSpeedPreconditioner": False,

    # Fused-kernel path for the RANS-SA residual (reference: useBlockettes,
    # doc/options.yaml:492). Deliberately ON here, where the JAX package
    # keeps it off (adflow_tpu/options.py:66-73): its only reason there is a
    # Mosaic DMA fault with closure-constant operands on the TPU, which has
    # no counterpart on CUDA. The kernel runs only on CUDA tensors
    # (physics/residual.py block_residual).
    "useBlockettes": True,

    # Discretization
    "discretization": "central plus scalar dissipation",
    # 'central plus scalar dissipation' | 'central plus matrix dissipation'
    # | 'upwind'
    "coarseDiscretization": "central plus scalar dissipation",
    "limiter": "van Albada",             # 'van Albada' | 'minmod' | 'no limiter' | 'first order'
    "vis4": 0.0156,
    "vis2": 0.25,
    "vis2Coarse": 0.5,
    "dissipationScalingExponent": 0.67,
    "dissipationLumpingParameter": 6.0,
    "riemannSolver": "Roe",              # for the upwind path
    "entropyFix": 0.05,

    # Iterative solver (smoother + MG)
    "smoother": "Runge-Kutta",           # 'Runge-Kutta' | 'DADI'
    "nCycles": 2000,
    "nCyclesCoarse": 500,
    "nSubiterTurb": 3,
    "CFL": 1.7,
    "CFLCoarse": 1.0,
    "MGCycle": "sg",                     # 'sg' | '2w' | '3v' | '3w' ...
    "MGStartLevel": -1,
    "nMGFine": 1,                        # smoothing sweeps on the fine level
    "nMGCoarse": 1,
    "resAveraging": "alternate",         # 'never' | 'always' | 'alternate'
                                         # (reference default: alternate)
    "smoothParameter": 1.5,
    "CFLLimit": 1.5,
    "rkReset": False,

    # free-stream-change state correction (reference:
    # initializeFlow.F90:191 infChangeCorrection, options at
    # pyADflow.py:5704-5706): when the AP's free stream changes under an
    # existing state (solveCL alpha steps, AP switches, restarts), shift/
    # rotate the state instead of restarting the transient
    "infChangeCorrection": True,
    "infChangeCorrectionTol": 1e-12,
    "infChangeCorrectionType": "offset",    # 'offset' | 'rotate'

    # Convergence
    "L2Convergence": 1e-8,
    "L2ConvergenceRel": 1e-16,
    "L2ConvergenceCoarse": 1e-2,
    "maxL2DeviationFactor": 1.0,

    # ANK (approximate Newton-Krylov, pseudo-transient)
    "useANKSolver": True,
    "ANKSwitchTol": 1e3,
    "ANKSubspaceSize": -1,            # -1: auto (50)
    "ANKMaxIter": 40,
    "ANKLinearSolveTol": 0.05,
    "ANKLinResMax": 0.1,
    "ANKJacobianLag": 10,
    "ANKPCUpdateTol": 0.5,
    "ANKCFL0": 5.0,
    "ANKCFLMin": 1.0,
    "ANKCFLLimit": 1e8,
    "ANKCFLFactor": 10.0,
    "ANKCFLExponent": 1.5,
    "ANKCFLCutback": 0.5,
    "ANKStepFactor": 1.0,
    "ANKStepMin": 0.01,
    "ANKConstCFLStep": 0.4,
    "ANKPhysicalLSTol": 0.2,
    "ANKPhysicalLSTolTurb": 0.99,
    "ANKUnsteadyLSTol": 1.0,
    # deviation from the reference default (1e-16 = stay first-order
    # forever): the exact-jvp ANK here is robust fully second-order, so
    # the default linearizes the exact residual immediately; scripts that
    # set a real threshold (1e-4..1e-6) get the reference's staged
    # first-order-then-second-order behavior (newton.py make_ank_step
    # approx mode)
    "ANKSecondOrdSwitchTol": 1e3,
    # deviation from the reference default (1e-16 = effectively never
    # coupled): the exact-jvp ANK here is robust fully coupled, so the
    # default couples immediately; reference scripts that set a real
    # threshold (e.g. 1e-4) get the reference's segregated-then-coupled
    # staging (newton.py make_ank_step segregated mode)
    "ANKCoupledSwitchTol": 1e3,
    "ANKTurbCFLScale": 1.0,
    "ANKUseTurbDADI": True,
    "ANKUseMatrixFree": True,
    "ANKNSubiterTurb": 1,
    # global PC family (reference: ANKGlobalPreconditioner,
    # doc/options.yaml:1070 — 'additive Schwarz' maps to the line-implicit
    # block PC here; 'multigrid' = the Galerkin stencil AMG, amg.F90)
    "ANKGlobalPreconditioner": "additive Schwarz",
    "ANKAMGLevels": 2,
    "ANKAMGNSmooth": 1,

    # NK (full Newton-Krylov)
    "useNKSolver": False,
    "NKSwitchTol": 1e-5,
    "NKSubspaceSize": 60,
    "NKLinearSolveTol": 0.3,
    "NKUseEW": True,
    "NKEWRTolExponent": 1.5,
    "NKJacobianLag": 20,
    "NKLS": "cubic",                     # 'cubic' | 'none' | 'non monotone'
    "NKFixedStep": 0.25,
    "NKGlobalPreconditioner": "additive Schwarz",
    "NKAMGLevels": 2,
    "NKAMGNSmooth": 1,
    "RKReset": False,

    # Adjoint
    "adjointL2Convergence": 1e-6,
    "adjointL2ConvergenceRel": 1e-16,
    "adjointMaxIter": 500,
    "adjointSubspaceSize": 100,
    "adjointMonitorStep": 10,
    "ADPC": False,
    "frozenTurbulence": False,
    "restartAdjoint": True,
    "applyAdjointPCSubspaceSize": 20,
    "adjointGlobalPreconditioner": "additive Schwarz",
    "adjointAMGLevels": 2,
    "adjointAMGNSmooth": 1,

    # Reference / freestream
    "liftIndex": 2,                      # 2: y is lift, 3: z is lift

    # Time accurate
    "timeIntegrationScheme": "BDF",      # 'BDF' | 'explicit RK'
    "timeAccuracy": 2,
    "nTimeStepsFine": 100,
    "deltaT": 0.010,
    "useALE": True,

    # Time spectral
    "timeIntervals": 1,
    "alphaMode": False,
    "omegaFourier": 0.0,

    # Overset
    "nearWallDist": 0.1,
    "backgroundVolScale": 1.0,
    "oversetProjTol": 1e-12,
    "overlapFactor": 0.9,
    "oversetLoadBalance": True,
    "useZipperMesh": True,
    "useOversetWallScaling": False,
    "selfZipCutoff": 120.0,
    "oversetPriority": {},

    # Misc / infra
    "partitionOnly": False,
    "partitionLikeNProc": -1,
    "loadImbalance": 0.1,
    "loadBalanceIter": 10,
    "setMonitor": True,
    "timeLimit": -1.0,
    # profiler hook of the JAX package (a trace directory); kept so option
    # dicts carry over unchanged — the port's solve raises when it is set
    "jaxProfileDir": None,
    "storeConvHist": True,

    # ----- device-side additions (no reference analogue) -----
    "precision": "auto",        # 'auto' | 'float32' | 'float64' | 'tf32'
                                # auto: float64 on CPU, float32 on CUDA
    "meshDevices": 1,            # number of chips in the block-parallel mesh
    "meshAxisName": "blocks",
    "blockPadding": "bucket",    # 'bucket' | 'max' — pad blocks to shape buckets
    "haloExchangeMode": "gather",  # 'gather' | 'ppermute'
    "deterministicReductions": True,
    "linePCAxes": "auto",        # line-implicit PC sweep directions
    "linePCKappa": 0.25,         # scalar-dissipation splitting factor
}

# Options that are accepted but currently ignored (stored, no effect yet) —
# kept so reference user scripts run unmodified. Everything used by the
# solver is consumed explicitly; using an option in this set emits no error.
# tests/test_options.py asserts every option NOT in this set has a consumer,
# so an entry here is an honest "not implemented yet", never a silent no-op.
_INERT_OPTIONS = {
    "printAllOptions",
    "gridPrecision", "solutionPrecision", "oversetPriority",
    "partitionLikeNProc", "loadImbalance", "loadBalanceIter",
    "useOversetWallScaling", "selfZipCutoff", "backgroundVolScale",
    "overlapFactor", "oversetLoadBalance", "alphaMode",
    # ALE metrics activate automatically whenever grid motion is present
    # (metrics vfI/vfJ/vfK); the flag itself has nothing left to gate
    "useALE",
    "rkReset", "RKReset",
    # --- pending features (tracked; remove from here when implemented) ---
    "flowType",                                   # internal-flow mode
    "ANKUseMatrixFree",    # always matrix-free (exact jvp); no assembled path
    "ADPC",
    "applyAdjointPCSubspaceSize",
    "nearWallDist", "oversetProjTol",
    "partitionOnly",
    # blockPadding: the stacked layout pads every block to ONE bucket (the
    # max dims) — 'max' semantics; multiple size buckets not implemented
    "blockPadding",
    "deterministicReductions",
}

_DEPRECATED_OPTIONS = {
    # reference deprecated list, pyADflow.py:6388
    "finaldistsortiterations", "useprecondtwoderivadjoint",
}


def get_default_options() -> Dict[str, Any]:
    """Return a fresh copy of the full default options dict.

    Reference analogue: ``ADFLOW._getDefaultOptions``
    (`ADflow: adflow/pyADflow.py:5632`).
    """
    return dict(_DEFAULT_OPTIONS)


class Options:
    """Immutable, case-insensitive validated view over the options dict.

    Access via attribute-ish ``opts['CFL']`` (any case). ``opts.asdict()``
    returns the canonical-name dict.
    """

    def __init__(self, user_options: Dict[str, Any] | None = None):
        canon = {k.lower(): k for k in _DEFAULT_OPTIONS}
        merged = dict(_DEFAULT_OPTIONS)
        unknown = []
        if user_options:
            for key, val in user_options.items():
                lk = key.lower()
                if lk in _DEPRECATED_OPTIONS:
                    continue
                if lk not in canon:
                    unknown.append(key)
                    continue
                merged[canon[lk]] = val
        if unknown:
            msgs = []
            for key in unknown:
                hint = difflib.get_close_matches(key.lower(), canon.keys(), n=1)
                msgs.append(f"'{key}'" + (f" (did you mean '{canon[hint[0]]}'?)" if hint else ""))
            raise ValueError("Unknown option(s): " + ", ".join(msgs))
        self._canon = canon
        self._data = MappingProxyType(merged)
        self._validate()

    # -- dict-ish interface --------------------------------------------------
    def __getitem__(self, key: str) -> Any:
        return self._data[self._canon[key.lower()]]

    def __contains__(self, key: str) -> bool:
        return key.lower() in self._canon

    def get(self, key: str, default: Any = None) -> Any:
        try:
            return self[key]
        except KeyError:
            return default

    def asdict(self) -> Dict[str, Any]:
        return dict(self._data)

    def replace(self, **kwargs: Any) -> "Options":
        d = self.asdict()
        d.update(kwargs)
        return Options(d)

    # -- validation ----------------------------------------------------------
    _CHOICES = {
        "equationtype": ("euler", "laminar ns", "rans"),
        "equationmode": ("steady", "unsteady", "time spectral"),
        "smoother": ("runge-kutta", "runge kutta", "dadi"),
        "discretization": (
            "central plus scalar dissipation",
            "central plus matrix dissipation",
            "upwind",
        ),
        "turbulencemodel": ("sa", "sa-edwards", "sst"),
        "limiter": ("van albada", "minmod", "no limiter", "first order"),
        "nkls": ("cubic", "none", "non monotone"),
        "ankglobalpreconditioner": ("additive schwarz", "multigrid"),
        "nkglobalpreconditioner": ("additive schwarz", "multigrid"),
        "adjointglobalpreconditioner": ("additive schwarz", "multigrid"),
        "precision": ("auto", "float32", "float64", "tf32", "mixed"),
        "haloexchangemode": ("gather", "ppermute"),
        "infchangecorrectiontype": ("offset", "rotate"),
    }

    def _validate(self) -> None:
        for lk, choices in self._CHOICES.items():
            val = self[lk]
            if isinstance(val, str) and val.lower() not in choices:
                raise ValueError(
                    f"Option '{self._canon[lk]}'='{val}' not in {choices}")
        if self["liftIndex"] not in (2, 3):
            raise ValueError("liftIndex must be 2 (y-lift) or 3 (z-lift)")
        if abs(float(self["gammaConstant"]) - 1.4) > 1e-12:
            raise NotImplementedError(
                "gammaConstant != 1.4 requires the variable-gamma "
                "thermodynamics (reference CpCurveFits.f90 / "
                "flowUtils.F90 computeGamma), which this framework does "
                "not implement; only air with gamma = 1.4 is supported")
