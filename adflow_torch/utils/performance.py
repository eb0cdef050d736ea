"""Dynamic handling-qualities performance metrics.

Reference analogues: ``adflow/pyDynamicPerformance.py`` and
``adflow/pyPerformanceClass.py`` (short-period approximation, CAP, and the
MIL-F-8785 "thumbnail" satisfactory-region constraint used in stability
optimizations). The underlying formulas are the standard longitudinal
2-DOF short-period approximation (McRuer, Ashkenas & Graham 1973, p. 309).

These pair with the framework's time-spectral stability derivatives
(``solvers/timespectral.stability_derivatives``: cl0/clalpha/clalphadot/
cmzalpha/cmzalphadot/cmzq...) to close the loop from a TS solve to a
handling-qualities constraint.

All inputs dimensional SI unless noted; derivatives are per radian.
"""

from __future__ import annotations

import math

G0 = 9.80665   # standard gravity, m/s^2


def short_period_frequency_damping(cmq, clalpha, cd, cmalpha, cmalphadot,
                                   mass, Iy, rho, area, U, chord):
    """Short-period natural frequency (rad/s) and damping ratio from the
    longitudinal 2-DOF approximation:

        Mq      = Cmq      * rho S U c^2 / (4 Iy)
        Zw      = -(CLa+CD) * rho S U     / (2 m)
        Malpha  = Cmalpha  * rho S U^2 c  / (2 Iy)
        Madot   = Cmadot   * rho S U c^2  / (4 Iy)

        w_sp^2  = Mq Zw - Malpha
        zeta    = -(Zw + Mq + Madot) / (2 w_sp)
    """
    mq = cmq * rho * area * U * chord ** 2 / (4.0 * Iy)
    zw = -(clalpha + cd) * rho * area * U / (2.0 * mass)
    malpha = cmalpha * rho * area * U ** 2 * chord / (2.0 * Iy)
    madot = cmalphadot * rho * area * U * chord ** 2 / (4.0 * Iy)
    wsp2 = mq * zw - malpha
    if wsp2 <= 0.0:
        raise ValueError(
            f"statically unstable short-period approximation "
            f"(Mq*Zw - Malpha = {wsp2:.4e} <= 0); frequency undefined")
    wsp = math.sqrt(wsp2)
    zeta = -(zw + mq + madot) / (2.0 * wsp)
    return wsp, zeta


def n_alpha(clalpha, rho, area, U, mass, g: float = G0):
    """Load-factor-per-alpha n/alpha = rho U^2 S CLa / (2 m g)."""
    return rho * U ** 2 * area * clalpha / (2.0 * mass * g)


def control_anticipation_parameter(wsp, nalpha):
    """CAP = w_sp^2 / (n/alpha) (controls-fixed interpretation;
    MIL-F-8785C level-1 band roughly 0.28-3.6 1/(g s^2))."""
    return wsp ** 2 / nalpha


def thumbnail_constraint(wn, damping_ratio):
    """Signed satisfactory-region constraint from the short-period
    "thumbnail" chart (frequency vs damping): <= 0 inside the
    satisfactory region, > 0 outside.

    The satisfactory contour is modeled as a rotated ellipse centered at
    (zeta, wn) = (0.76, 3.01 rad/s), semi-axes 1/sqrt(2.2) and
    1/sqrt(11), major axis tilted 80 deg from the damping axis — the same
    analytic approximation of the chart the reference optimizer
    constrains (pyDynamicPerformance.py:28)."""
    theta = math.radians(80.0)
    zc, wc = 0.76, 3.01
    a, b = 2.2, 11.0
    x = (damping_ratio - zc) * math.cos(theta) + (wn - wc) * math.sin(theta)
    y = (wn - wc) * math.cos(theta) - (damping_ratio - zc) * math.sin(theta)
    return a * x * x + b * y * y - 1.0


def handling_qualities(ts_stab: dict, *, mass, Iy, rho, area, U, chord,
                       cd: float = 0.0, g: float = G0) -> dict:
    """One-call bridge from the solver's time-spectral stability
    derivative dict (keys clalpha, cmzalpha, cmzalphadot, cmzq when
    present) to the handling-qualities metrics used as optimization
    constraints."""
    cmq = float(ts_stab.get("cmzq", 0.0))
    wsp, zeta = short_period_frequency_damping(
        cmq, float(ts_stab["clalpha"]), cd, float(ts_stab["cmzalpha"]),
        float(ts_stab.get("cmzalphadot", 0.0)), mass, Iy, rho, area, U,
        chord)
    na = n_alpha(float(ts_stab["clalpha"]), rho, area, U, mass, g)
    return {
        "wsp": wsp,
        "damping": zeta,
        "n_alpha": na,
        "cap": control_anticipation_parameter(wsp, na),
        "thumbnail": thumbnail_constraint(wsp, zeta),
    }
