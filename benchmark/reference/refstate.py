# Frozen copy of adflow_torch/core/refstate.py for the benchmark's reference, its
# imports made local.
"""Free-stream / reference state and the AeroProblem container.

Reference analogues:
- ``referenceState`` (`ADflow: src/initFlow/initializeFlow.F90:10`)
  computes the nondimensional free stream ``winf`` and reference values.
- ``baseclasses.AeroProblem`` (external dep of the reference) carries
  mach/alpha/beta/Re/T/P + areaRef/chordRef/xRef; our ``AeroProblem`` mirrors
  the constructor-keyword subset the reference tests use
  (`ADflow: tests/reg_tests/reg_aeroproblems.py`).

Nondimensionalization (documented, differs from the reference's pRef/rhoRef
scheme but is self-consistent):
  rho' = rho/rhoInf, u' = u/aInf, p' = p/(rhoInf aInf^2), T' = T/TInf,
  mu' = mu/(rhoInf aInf L) with L = 1 mesh unit.
So the free stream is rho'=1, |V'|=Mach, p'=1/gamma, T'=1, and
muInf' = Mach * reynoldsLength / reynolds. Dynamic pressure q' = 0.5 Mach^2.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

# Perfect-gas constants (reference defaults: doc/options.yaml gammaConstant,
# RGasDim; Sutherland constants in src/modules/flowVarRefState usage).
GAMMA = 1.4
R_GAS = 287.87
MU_SUTH = 1.716e-5      # kg/(m s) at T_SUTH_REF
T_SUTH_REF = 273.15     # K
S_SUTH = 110.55         # K
PR_LAMINAR = 0.72
PR_TURB = 0.90
SA_NU_TILDE_RATIO = 3.0  # nuTilde_inf / nu_inf, standard SA freestream


def sutherland_ratio(t_ratio, t_inf_dim: float):
    """mu(T)/mu(TInf) with T given as the nondimensional ratio T/TInf."""
    t_dim = t_ratio * t_inf_dim
    return (
        (t_dim / t_inf_dim) ** 1.5
        * (t_inf_dim + S_SUTH)
        / (t_dim + S_SUTH)
    )


class AeroProblem:
    """Flow-condition + reference-quantity container (baseclasses-compatible
    keyword subset). Angles in degrees; SI units for dimensional inputs."""

    def __init__(
        self,
        name: str = "ap",
        mach: float = 0.5,
        alpha: float = 0.0,
        beta: float = 0.0,
        reynolds: Optional[float] = None,
        reynoldsLength: float = 1.0,
        T: Optional[float] = None,
        P: Optional[float] = None,
        rho: Optional[float] = None,
        altitude: Optional[float] = None,
        areaRef: float = 1.0,
        chordRef: float = 1.0,
        spanRef: float = 1.0,
        xRef: float = 0.0,
        yRef: float = 0.0,
        zRef: float = 0.0,
        evalFuncs: Sequence[str] = (),
        rotRate: Optional[Sequence[float]] = None,
        rotCenter: Sequence[float] = (0.0, 0.0, 0.0),
        machGrid: float = 0.0,
        **kwargs,
    ):
        self.name = name
        self.mach = float(mach)
        self.alpha = float(alpha)
        self.beta = float(beta)
        self.reynoldsLength = float(reynoldsLength)
        self.areaRef = float(areaRef)
        self.chordRef = float(chordRef)
        self.spanRef = float(spanRef)
        self.xRef, self.yRef, self.zRef = float(xRef), float(yRef), float(zRef)
        self.evalFuncs = list(evalFuncs)
        # rigid grid rotation (reference AeroProblem xRot/yRot/zRot rates,
        # consumed by gridVelocitiesFineLevel): rad/s, dimensional
        self.rotRate = None if rotRate is None else [float(r) for r in rotRate]
        self.rotCenter = [float(c) for c in rotCenter]
        # uniform grid translation Mach (reference inputPhysics machGrid:
        # grid velocity = -machGrid * aInf * velDirFreestream,
        # solverUtils.F90:414)
        self.machGrid = float(machGrid)
        self.solverOptions: Dict = dict(kwargs.pop("solverOptions", {}))
        # Unknown extra kwargs are stored (parity with baseclasses tolerance).
        self._extras = kwargs

        if altitude is not None:
            # ISA troposphere/low stratosphere, enough for test parity.
            T, P = _isa_atmosphere(altitude)
        if T is None:
            T = 288.15
        self.T = float(T)
        if P is None and rho is not None:
            P = rho * R_GAS * self.T
        if P is None:
            P = 101325.0
        self.P = float(P)
        self.rho = self.P / (R_GAS * self.T)
        self.a_dim = math.sqrt(GAMMA * R_GAS * self.T)
        self.V_dim = self.mach * self.a_dim

        if reynolds is not None:
            self.reynolds = float(reynolds)
            self.mu_dim = self.rho * self.V_dim * self.reynoldsLength / self.reynolds
        else:
            self.mu_dim = MU_SUTH * (self.T / T_SUTH_REF) ** 1.5 * (
                T_SUTH_REF + S_SUTH) / (self.T + S_SUTH)
            self.reynolds = (
                self.rho * self.V_dim * self.reynoldsLength / self.mu_dim
                if self.V_dim > 0 else 0.0
            )

    # -- derived, nondimensional ------------------------------------------
    @property
    def alpha_rad(self) -> float:
        return math.radians(self.alpha)

    @property
    def beta_rad(self) -> float:
        return math.radians(self.beta)


def _isa_atmosphere(h: float) -> Tuple[float, float]:
    """International standard atmosphere T(K), P(Pa) at altitude h (m)."""
    if h <= 11000.0:
        T = 288.15 - 0.0065 * h
        P = 101325.0 * (T / 288.15) ** 5.25588
    else:
        T = 216.65
        P = 22632.0 * math.exp(-9.80665 * (h - 11000.0) / (R_GAS * T))
    return T, P


def flow_directions(alpha_deg: float, beta_deg: float, lift_index: int
                    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(velDir, dragDir, liftDir) unit vectors; MACH convention.

    liftIndex=2: alpha rotates in the x-y plane (y = lift axis);
    liftIndex=3: alpha rotates in the x-z plane (z = lift axis).
    Matches baseclasses.AeroProblem used by the reference.
    """
    a = math.radians(alpha_deg)
    b = math.radians(beta_deg)
    ca, sa, cb, sb = math.cos(a), math.sin(a), math.cos(b), math.sin(b)
    if lift_index == 2:
        vel = np.array([ca * cb, sa * cb, -sb])
        lift = np.array([-sa, ca, 0.0])
    elif lift_index == 3:
        vel = np.array([ca * cb, -sb, sa * cb])
        lift = np.array([-sa, 0.0, ca])
    else:
        raise ValueError("liftIndex must be 2 or 3")
    drag = vel / np.linalg.norm(vel)
    return vel, drag, lift


@dataclasses.dataclass(frozen=True)
class ReferenceState:
    """Nondimensional free-stream state + scaling factors.

    ``winf`` layout (conservative): [rho, rho*u, rho*v, rho*w, rho*E]
    (+ trailing primitive turbulence variables, e.g. SA nuTilde).
    """

    mach: float
    alpha: float
    beta: float
    lift_index: int
    t_inf_dim: float          # dimensional TInf for Sutherland
    p_inf: float              # nondim = 1/gamma
    rho_inf: float            # nondim = 1
    u_inf: np.ndarray         # nondim velocity vector, |u| = mach
    mu_inf: float             # nondim laminar viscosity
    nu_tilde_inf: float       # SA working variable freestream (nondim)
    vel_dir: np.ndarray
    drag_dir: np.ndarray
    lift_dir: np.ndarray
    q_inf: float              # 0.5 * mach^2
    area_ref: float
    chord_ref: float
    moment_ref: np.ndarray    # (xRef, yRef, zRef)
    n_turb: int               # number of turbulence variables carried in w
    k_inf: float = 0.0        # SST freestream k (nondim)
    omega_inf: float = 1.0    # SST freestream omega (nondim)
    reynolds: float = 0.0     # the AP Reynolds number (0 = inviscid)
    # dimensionalization scale for forces/moments: rho_inf_dim a_inf_dim^2
    # = gamma P_inf_dim (Pa). The freestream P/rho design-variable chains
    # (reference iDV['p']/iDV['rho'], pyADflow.py:6450-6451) enter the
    # dimensional cost functions through this field.
    p_ref_dim: float = 1.0
    # wall-function wall treatment (reference: useWallFunctions option,
    # solverUtils.F90:2483 computeUtau + turbCurveFits.F90): when True,
    # viscous wall ghost velocities are scaled so the wall face produces
    # the Spalding-law shear instead of the linear-sublayer gradient —
    # carried here because ReferenceState travels into every BC evaluation
    # (physics/bc.py). Static Python bool: changing it retraces.
    wall_fn: bool = False

    @property
    def nw(self) -> int:
        return 5 + self.n_turb

    def winf(self) -> np.ndarray:
        e_int = self.p_inf / ((GAMMA - 1.0))
        vel = self.u_inf
        rho_e = e_int + 0.5 * self.rho_inf * float(vel @ vel)
        w = [self.rho_inf, *(self.rho_inf * vel), rho_e]
        if self.n_turb == 1:          # SA nuTilde
            w.append(self.nu_tilde_inf)
        elif self.n_turb == 2:        # SST (k, omega)
            w.extend([self.k_inf, self.omega_inf])
        return np.array(w)


def make_reference_state(ap: AeroProblem, lift_index: int = 2,
                         n_turb: int = 0,
                         eddy_vis_inf_ratio: float = 0.009
                         ) -> ReferenceState:
    vel_dir, drag_dir, lift_dir = flow_directions(ap.alpha, ap.beta, lift_index)
    u_inf = ap.mach * vel_dir
    # muInf' = Mach * L_re / Re (see module docstring); inviscid flows get 0.
    mu_inf = (ap.mach * ap.reynoldsLength / ap.reynolds
              if ap.reynolds and ap.reynolds > 0 else 0.0)
    nu_tilde_inf = SA_NU_TILDE_RATIO * mu_inf  # rhoInf' = 1 -> nu' = mu'
    # SST free stream (reference: initializeFlow referenceState SST branch;
    # defaults turbIntensityInf ~ 0.1%, eddyVisInfRatio option = 0.009):
    #   kInf = 1.5 (I |u|)^2,  omegaInf = rho kInf / (mu * evr)
    turb_intensity = 1e-3
    k_inf = 1.5 * (turb_intensity * ap.mach) ** 2
    omega_inf = (k_inf / (mu_inf * eddy_vis_inf_ratio)
                 if mu_inf > 0 else 1.0)
    return ReferenceState(
        mach=ap.mach, alpha=ap.alpha, beta=ap.beta, lift_index=lift_index,
        t_inf_dim=ap.T, p_inf=1.0 / GAMMA, rho_inf=1.0, u_inf=u_inf,
        mu_inf=mu_inf, nu_tilde_inf=nu_tilde_inf,
        vel_dir=vel_dir, drag_dir=drag_dir, lift_dir=lift_dir,
        q_inf=0.5 * ap.mach ** 2, area_ref=ap.areaRef, chord_ref=ap.chordRef,
        moment_ref=np.array([ap.xRef, ap.yRef, ap.zRef]), n_turb=n_turb,
        k_inf=k_inf, omega_inf=omega_inf,
        reynolds=float(ap.reynolds or 0.0),
        p_ref_dim=ap.rho * ap.a_dim ** 2,
    )
