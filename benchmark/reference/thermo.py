# Frozen copy of adflow_torch/physics/thermo.py for the benchmark's reference, its
# imports made local.
"""Thermodynamics on conservative state tensors (counterpart of
adflow_tpu/physics/thermo.py).

State layout w[..., :]: [rho, rho*u, rho*v, rho*w, rho*E, (nuTilde, ...)].
Nondimensionalization: see core/refstate.py — p' = rho' T' / gamma,
a'^2 = gamma p'/rho' = T'.
"""

from __future__ import annotations

import torch

from .refstate import GAMMA, S_SUTH

IRHO, IMX, IMY, IMZ, IRHOE, ITURB = 0, 1, 2, 3, 4, 5


def velocity(w):
    return w[..., IMX:IMZ + 1] / w[..., IRHO:IRHO + 1]


def pressure(w, gamma: float = GAMMA):
    """p = (gamma-1) (rhoE - 0.5 |m|^2 / rho)."""
    ke = 0.5 * torch.sum(w[..., IMX:IMZ + 1] ** 2, dim=-1) / w[..., IRHO]
    return (gamma - 1.0) * (w[..., IRHOE] - ke)


def temperature(w, gamma: float = GAMMA):
    """Nondim T' = gamma p' / rho' (=1 in the free stream)."""
    return gamma * pressure(w, gamma) / w[..., IRHO]


def sound_speed2(w, gamma: float = GAMMA):
    return gamma * pressure(w, gamma) / w[..., IRHO]


def total_enthalpy_flux_var(w, p):
    """rhoE + p — the convected total-enthalpy density."""
    return w[..., IRHOE] + p


def laminar_viscosity(t_nd, mu_inf: float, t_inf_dim: float):
    """Sutherland's law on the nondimensional temperature ratio."""
    s = S_SUTH / t_inf_dim
    return mu_inf * t_nd ** 1.5 * (1.0 + s) / (t_nd + s)


def conservative_from_primitive(rho, u, p, gamma: float = GAMMA):
    """Stack [rho, rho u, rhoE] from primitives; u has trailing dim 3."""
    rhoE = p / (gamma - 1.0) + 0.5 * rho * torch.sum(u * u, dim=-1)
    return torch.cat(
        [rho[..., None], rho[..., None] * u, rhoE[..., None]], dim=-1)
