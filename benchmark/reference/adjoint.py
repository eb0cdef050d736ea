"""The reference state and free stream as functions of the design
variables: a frozen copy of ``traced_reference_state`` and ``traced_winf``
of adflow_torch's ``adjoint/api.py``."""

from __future__ import annotations

import dataclasses
import math

import torch

from .refstate import GAMMA, ReferenceState


def traced_reference_state(base: ReferenceState, params) -> ReferenceState:
    """The reference state with the flow-condition fields rebuilt as
    tensors of ``params``, so that derivatives with respect to alpha, beta,
    mach, reynolds, T, P and xref reach the BCs, the viscosity and the
    force nondimensionalization."""
    alpha = params["alpha"] * (math.pi / 180.0)
    beta = params["beta"] * (math.pi / 180.0)
    mach = params["mach"]
    ca, sa = torch.cos(alpha), torch.sin(alpha)
    cb, sb = torch.cos(beta), torch.sin(beta)
    if base.lift_index == 2:
        vel_dir = torch.stack([ca * cb, sa * cb, -sb])
        lift_dir = torch.stack([-sa, ca, torch.zeros_like(sa)])
    else:
        vel_dir = torch.stack([ca * cb, -sb, sa * cb])
        lift_dir = torch.stack([-sa, torch.zeros_like(sa), ca])
    # mu_inf' = mach * L_re / Re: the Mach and Reynolds chains
    re_over_l = (base.mu_inf / base.mach if base.mach > 0 and base.mu_inf > 0
                 else 0.0)
    mu_inf = mach * re_over_l
    extra = {}
    if "reynolds" in params and base.reynolds > 0:
        mu_inf = mu_inf * (base.reynolds / params["reynolds"])
    if "T" in params:
        # the dimensional T_inf drives the Sutherland ratio S/T_inf
        extra["t_inf_dim"] = params["T"]
    if "P" in params:
        # reaches the dimensional cost functions through p_ref_dim = gamma P
        extra["p_ref_dim"] = GAMMA * params["P"]
    if "xref" in params:
        extra["moment_ref"] = params["xref"]
    if base.n_turb == 2:
        # the SST free stream of make_reference_state: k = 1.5 (I M)^2,
        # omega = k / (mu_inf eddyVisInfRatio), the ratio recovered from
        # the base state
        k_inf = 1.5 * (1e-3 * mach) ** 2
        extra["k_inf"] = k_inf
        extra["omega_inf"] = (
            k_inf / (mu_inf * (base.k_inf / (base.mu_inf * base.omega_inf)))
            if base.mu_inf > 0 else base.omega_inf)
    return dataclasses.replace(
        base, u_inf=mach * vel_dir, mu_inf=mu_inf,
        nu_tilde_inf=3.0 * mu_inf, vel_dir=vel_dir, drag_dir=vel_dir,
        lift_dir=lift_dir, q_inf=0.5 * mach ** 2, **extra)


def traced_winf(ref: ReferenceState):
    """The conservative free stream of a traced reference state: SA's
    nuTilde, or SST's k and omega, as ``ReferenceState.winf``."""
    vel = ref.u_inf
    rho_e = ref.p_inf / (GAMMA - 1.0) + 0.5 * torch.sum(vel * vel)
    parts = [torch.ones(1, dtype=vel.dtype, device=vel.device), vel,
             rho_e[None]]
    turb = {1: ("nu_tilde_inf",), 2: ("k_inf", "omega_inf")}.get(
        ref.n_turb, ())
    parts += [torch.as_tensor(getattr(ref, f), dtype=vel.dtype,
                              device=vel.device).reshape(1) for f in turb]
    return torch.cat(parts)
