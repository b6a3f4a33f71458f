"""Frenet-frame single-track dynamics.

Port of ``irbfn_tpu/dynamics/frenet.py``:

- state layout ``[s, ey, delta, vx, vy, wz, epsi]`` (7,) + path curvature
- control layout ``[accl, steer_vel]`` (2,)
- high-speed model with simplified-Pacejka lateral tire forces
  ``Fy = D sin(C atan(B alpha))``, ``D = mu m g / 2``
- low-speed kinematic model, and the speed switch at ``V_SWITCH``.

``eps_denom`` stays None on the serving path: the planner's rollout sees
the exact ``1 - ey*curv`` denominator. Training rollouts
(``integrate_frenet(..., eps_denom=0.05)`` in ``train/trainer.py``) floor
its magnitude, because an early-epoch net can push ey past the path's
curvature center, and one singular row would poison Adam's state for good.
"""

from __future__ import annotations

import torch

from irbfn_tpu_torch.dynamics.params import G, VehicleParams, as_params

# state indices
IS, IEY, IDELTA, IVX, IVY, IWZ, IEPSI = range(7)
FRENET_STATE_DIM = 7

V_SWITCH = 1.0  # kinematic/dynamic switch speed
B_TIRE = 1.0  # Pacejka B


def _clip(a, lim):
    return torch.minimum(torch.maximum(a, -lim), lim)


def tire_forces(delta, vx, vy, wz, p: VehicleParams):
    """Front/rear lateral tire forces with simplified Pacejka magic formula."""
    d_peak = p.mu * p.m * G / 2.0
    vx_safe = torch.where(vx.abs() < 1e-3, torch.full_like(vx, 1e-3), vx)
    alpha_f = delta - torch.atan2(vy + p.lf * wz, vx_safe)
    # NOTE: the rear slip angle uses lf (not lr), as the reference model
    # does; kept for parity.
    alpha_r = -torch.atan2(vy - p.lf * wz, vx_safe)
    fyf = d_peak * torch.sin(p.C_Sf * torch.atan(B_TIRE * alpha_f))
    fyr = d_peak * torch.sin(p.C_Sr * torch.atan(B_TIRE * alpha_r))
    return fyf, fyr


def _one_m_ke(ey, curv, eps_denom):
    """``1 - ey*curv``, with an optional magnitude floor for training
    rollouts (None keeps the exact, possibly singular, form)."""
    d = 1.0 - ey * curv
    if eps_denom is None:
        return d
    return torch.where(d >= 0, torch.clamp(d, min=eps_denom),
                       torch.clamp(d, max=-eps_denom))


def frenet_hs_deriv(x: torch.Tensor, u: torch.Tensor, curv: torch.Tensor,
                    p: VehicleParams, saturate: bool = True,
                    eps_denom: float | None = None) -> torch.Tensor:
    """High-speed (dynamic, tire-force) Frenet derivative, batched.

    Args:
        x: ``(..., 7)``; u: ``(..., 2)``; curv: ``(...,)``
        saturate: clip delta and the controls to their physical limits.
    """
    ey = x[..., IEY]
    delta = x[..., IDELTA]
    vx = x[..., IVX]
    vy = x[..., IVY]
    wz = x[..., IWZ]
    epsi = x[..., IEPSI]
    a = u[..., 0]
    sv = u[..., 1]
    if saturate:
        delta = _clip(delta, p.s_max)
        a = _clip(a, p.a_max)
        sv = _clip(sv, p.sv_max)

    fyf, fyr = tire_forces(delta, vx, vy, wz, p)
    s_dot = ((vx * torch.cos(epsi) - vy * torch.sin(epsi))
             / _one_m_ke(ey, curv, eps_denom))
    return torch.stack([
        s_dot,
        vx * torch.sin(epsi) + vy * torch.cos(epsi),
        sv,
        a - (fyf * torch.sin(delta)) / p.m + wz * vy,
        (fyf * torch.cos(delta) + fyr) / p.m - wz * vx,
        (p.lf * fyf * torch.cos(delta) - p.lr * fyr) / p.I,
        wz - s_dot * curv,
    ], dim=-1)


def frenet_ls_deriv(x: torch.Tensor, u: torch.Tensor, curv: torch.Tensor,
                    p: VehicleParams, saturate: bool = True,
                    eps_denom: float | None = None) -> torch.Tensor:
    """Low-speed (kinematic) Frenet derivative, batched; the vy and wz
    derivatives are zero."""
    ey = x[..., IEY]
    delta = x[..., IDELTA]
    vx = x[..., IVX]
    epsi = x[..., IEPSI]
    a = u[..., 0]
    sv = u[..., 1]
    if saturate:
        delta = _clip(delta, p.s_max)
        a = _clip(a, p.a_max)
        sv = _clip(sv, p.sv_max)

    s_dot = (vx * torch.cos(epsi)) / _one_m_ke(ey, curv, eps_denom)
    zero = torch.zeros_like(vx)
    return torch.stack([
        s_dot,
        vx * torch.sin(epsi),
        sv,
        a,
        zero,
        zero,
        (vx * torch.tan(delta)) / (p.lr + p.lf) - curv * s_dot,
    ], dim=-1)


def frenet_deriv(x, u, curv, p: VehicleParams, blend: str = "switch",
                 v_switch: float = V_SWITCH, saturate: bool = True,
                 eps_denom: float | None = None) -> torch.Tensor:
    """Frenet derivative with selectable model blending: "switch" (speed
    switched at ``v_switch``), "ls" (always low-speed) or "hs"."""
    if blend == "ls":
        return frenet_ls_deriv(x, u, curv, p, saturate, eps_denom)
    if blend == "hs":
        return frenet_hs_deriv(x, u, curv, p, saturate, eps_denom)
    if blend != "switch":
        raise ValueError(f"unknown blend {blend!r}")
    speed = torch.sqrt(x[..., IVX] ** 2 + x[..., IVY] ** 2)
    use_hs = (speed >= v_switch)[..., None]
    return torch.where(use_hs,
                       frenet_hs_deriv(x, u, curv, p, saturate, eps_denom),
                       frenet_ls_deriv(x, u, curv, p, saturate, eps_denom))


def frenet_rollout(x0: torch.Tensor, controls: torch.Tensor,
                   curv: torch.Tensor, p: VehicleParams, blend: str = "ls",
                   integrator: str = "euler",
                   eps_denom: float | None = None) -> torch.Tensor:
    """Integrate a control sequence in the Frenet frame (constant curvature
    over the horizon).

    Args:
        x0: ``(..., 7)``; controls: ``(..., T, 2)``; curv: ``(...,)``
    Returns:
        states after each step, ``(..., T, 7)``
    """
    if integrator not in ("euler", "rk4"):
        raise ValueError(f"unknown integrator {integrator!r}")
    dt = _dt(p)

    def deriv(x, u):
        return frenet_deriv(x, u, curv, p, blend=blend, eps_denom=eps_denom)

    x = x0
    states = []
    for t in range(controls.shape[-2]):
        u = controls[..., t, :]
        if integrator == "euler":
            x = x + deriv(x, u) * dt
        else:
            k1 = deriv(x, u)
            k2 = deriv(x + 0.5 * dt * k1, u)
            k3 = deriv(x + 0.5 * dt * k2, u)
            k4 = deriv(x + dt * k3, u)
            x = x + (dt / 6.0) * (k1 + 2.0 * k2 + 2.0 * k3 + k4)
        states.append(x)
    return torch.stack(states, dim=-2)


def _dt(p: VehicleParams) -> torch.Tensor:
    """dt may be 0-dim or per lane; add a state-dim axis to a per-lane dt."""
    return p.dt[..., None] if p.dt.ndim > 0 else p.dt


def integrate_frenet(x_and_u: torch.Tensor, params_vec, horizon: int = 5,
                     eps_denom: float | None = None) -> torch.Tensor:
    """Reference-ABI 5-step low-speed Frenet rollout: input rows
    ``[s, ey, delta, vx, vy, wz, epsi, curv, accl_0.., sv_0..]`` (control
    tail column-major); returns ``(batch, T, 8)`` whose last column carries
    the (constant) curvature, the reference's 8-dim carry."""
    p = as_params(params_vec, x_and_u)
    x0 = x_and_u[..., :FRENET_STATE_DIM]
    curv = x_and_u[..., FRENET_STATE_DIM]
    tail = x_and_u[..., FRENET_STATE_DIM + 1:]
    controls = torch.stack([tail[..., :horizon],
                            tail[..., horizon:2 * horizon]], dim=-1)
    states = frenet_rollout(x0, controls, curv, p, blend="ls",
                            integrator="euler", eps_denom=eps_denom)
    curv_col = curv[..., None, None].expand(states.shape[:-1] + (1,))
    return torch.cat([states, curv_col.to(states.dtype)], dim=-1)


def frenet_onestep(x_u: torch.Tensor, params_vec) -> torch.Tensor:
    """Reference-ABI one-step reduced-state update: input rows
    ``[ey, delta, vx, vy, wz, epsi, curv, <unused>, accl, sv]``; returns the
    6-dim reduced next state ``[ey, delta, vx, vy, wz, epsi]`` (the s column
    is dropped)."""
    p = as_params(params_vec, x_u)
    zeros = torch.zeros_like(x_u[..., 0])
    x = torch.stack([zeros, x_u[..., 0], x_u[..., 1], x_u[..., 2],
                     x_u[..., 3], x_u[..., 4], x_u[..., 5]], dim=-1)
    curv = x_u[..., 6]
    u = x_u[..., 8:10]
    x_new = x + frenet_ls_deriv(x, u, curv, p) * _dt(p)
    return x_new[..., 1:]
