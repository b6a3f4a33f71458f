"""Cartesian single-track (dynamic bicycle) and kinematic-bicycle dynamics.

Port of ``irbfn_tpu/dynamics/single_track.py`` (the closed-loop
simulator's model; the CommonRoad-exact variant is still to be ported):

- state layout ``[x, y, delta, v, psi, psi_dot, beta]`` (7,)
- control layout ``[accl, steer_vel]`` (2,)

Every function is batched over the leading axes of its tensors, and the
parameters may be 0-dim or per-lane ``(B,)`` tensors.
"""

from __future__ import annotations

import torch

from irbfn_tpu_torch.dynamics.params import G, VehicleParams

# state indices
IX, IY, IDELTA, IV, IPSI, IPSIDOT, IBETA = range(7)
ST_STATE_DIM = 7
CONTROL_DIM = 2

V_BLEND = 3.0  # kinematic/dynamic switching speed [m/s]


def _clip(a, lim):
    """``clip(a, -lim, lim)`` with a tensor limit that may be per lane."""
    return torch.minimum(torch.maximum(a, -lim), lim)


def st_deriv(x: torch.Tensor, u: torch.Tensor,
             p: VehicleParams) -> torch.Tensor:
    """Dynamic single-track derivative, batched over leading axes.

    Args:
        x: states ``(..., 7)``; u: controls ``(..., 2)``
    Returns:
        dx/dt ``(..., 7)``
    """
    delta = _clip(x[..., IDELTA], p.s_max)
    v = _clip(x[..., IV], p.v_max)
    psi = x[..., IPSI]
    psi_dot = x[..., IPSIDOT]
    beta = x[..., IBETA]
    accl = _clip(u[..., 0], p.a_max)
    sv = _clip(u[..., 1], p.sv_max)

    # axle load transfer terms
    load_f = G * p.lr - accl * p.h
    load_r = G * p.lf + accl * p.h
    wb = p.lf + p.lr

    # guard v~0 for the 1/v terms; the blend selects kinematic there anyway
    tiny = torch.where(v < 0, torch.full_like(v, -1e-3),
                       torch.full_like(v, 1e-3))
    v_safe = torch.where(v.abs() < 1e-3, tiny, v)

    psi_ddot = (p.mu * p.m / (p.I * wb)) * (
        p.lf * p.C_Sf * load_f * delta
        + (p.lr * p.C_Sr * load_r - p.lf * p.C_Sf * load_f) * beta
        - (p.lf**2 * p.C_Sf * load_f + p.lr**2 * p.C_Sr * load_r)
        * (psi_dot / v_safe)
    )
    beta_dot = (p.mu / (v_safe * wb)) * (
        p.C_Sf * load_f * delta
        - (p.C_Sr * load_r + p.C_Sf * load_f) * beta
        + (p.C_Sr * load_r * p.lr - p.C_Sf * load_f * p.lf)
        * (psi_dot / v_safe)
    ) - psi_dot

    return torch.stack([v * torch.cos(psi + beta), v * torch.sin(psi + beta),
                        sv, accl, psi_dot, psi_ddot, beta_dot], dim=-1)


def ks_deriv(x: torch.Tensor, u: torch.Tensor,
             p: VehicleParams) -> torch.Tensor:
    """Kinematic-bicycle derivative in the 7-dim ST state layout, batched."""
    delta = _clip(x[..., IDELTA], p.s_max)
    v = _clip(x[..., IV], p.v_max)
    psi = x[..., IPSI]
    accl = _clip(u[..., 0], p.a_max)
    sv = _clip(u[..., 1], p.sv_max)
    zero = torch.zeros_like(v)
    return torch.stack([v * torch.cos(psi), v * torch.sin(psi), sv, accl,
                        (v / (p.lf + p.lr)) * torch.tan(delta), zero, zero],
                       dim=-1)


def blended_deriv(x: torch.Tensor, u: torch.Tensor, p: VehicleParams,
                  v_blend: float = V_BLEND) -> torch.Tensor:
    """Speed-switched derivative: dynamic ST above ``v_blend``, kinematic
    below, branchless over the batch."""
    v = _clip(x[..., IV], p.v_max)
    use_dyn = (v > v_blend)[..., None]
    return torch.where(use_dyn, st_deriv(x, u, p), ks_deriv(x, u, p))


def _bcast_dt(dt: torch.Tensor) -> torch.Tensor:
    """dt may be 0-dim or per lane; add a state-dim axis to a per-lane dt."""
    return dt[..., None] if dt.ndim > 0 else dt


def euler_step(deriv_fn, x, u, p: VehicleParams):
    return x + deriv_fn(x, u, p) * _bcast_dt(p.dt)


def rk4_step(deriv_fn, x, u, p: VehicleParams):
    dt = _bcast_dt(p.dt)
    k1 = deriv_fn(x, u, p)
    k2 = deriv_fn(x + 0.5 * dt * k1, u, p)
    k3 = deriv_fn(x + 0.5 * dt * k2, u, p)
    k4 = deriv_fn(x + dt * k3, u, p)
    return x + (dt / 6.0) * (k1 + 2.0 * k2 + 2.0 * k3 + k4)
