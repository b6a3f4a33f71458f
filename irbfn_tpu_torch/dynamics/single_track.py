"""Cartesian single-track (dynamic bicycle) and kinematic-bicycle dynamics.

Port of ``irbfn_tpu/dynamics/single_track.py``:

- state layout ``[x, y, delta, v, psi, psi_dot, beta]`` (7,)
- control layout ``[accl, steer_vel]`` (2,)
- the closed-loop simulator's speed-blended model (``blended_deriv``), the
  CommonRoad-exact model with its input constraints (``st_deriv_cr``,
  ``ks_deriv_cr``), the Cartesian NMPC oracle's tanh-mixed model
  (``st_mixed_deriv``), and the reference-ABI rollouts ``integrate_st`` and
  ``kinematic_onestep`` that the training losses integrate through.

Every function is batched over the leading axes of its tensors, and the
parameters may be 0-dim or per-lane ``(B,)`` tensors.
"""

from __future__ import annotations

import torch

from irbfn_tpu_torch.dynamics.params import G, VehicleParams, as_params

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


# --------------------------------------------------- CommonRoad-exact model

V_SWITCH_CR = 7.319  # wheel-spin switching speed [m/s]
V_LOW_CR = 0.5  # |v| below which the ST model falls back to KS at the CoG


def _like(value, ref: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(value, dtype=ref.dtype, device=ref.device)


def accl_constraint(v, accl, p: VehicleParams, v_switch: float = V_SWITCH_CR,
                    v_min=None):
    """CommonRoad acceleration constraint, branchless: the positive limit
    decays as a_max*v_switch/v above the wheel-spin speed; acceleration
    pushing past the velocity box is zeroed."""
    v_min = -p.v_max if v_min is None else _like(v_min, v)
    pos_limit = torch.where(v > v_switch,
                            p.a_max * v_switch / torch.clamp(v, min=1e-9),
                            _like(p.a_max, v))
    a = torch.minimum(torch.maximum(accl, -_like(p.a_max, v)), pos_limit)
    pinned = ((v <= v_min) & (accl <= 0)) | ((v >= p.v_max) & (accl >= 0))
    return torch.where(pinned, torch.zeros_like(a), a)


def steer_constraint(delta, sv, p: VehicleParams, s_min=None, sv_min=None):
    """CommonRoad steering-velocity constraint, branchless: steering pushing
    past the angle box is zeroed, otherwise rate-clipped."""
    s_min = -p.s_max if s_min is None else _like(s_min, delta)
    sv_min = -p.sv_max if sv_min is None else sv_min
    svc = torch.minimum(torch.maximum(sv, _like(sv_min, sv)),
                        _like(p.sv_max, sv))
    pinned = ((delta <= s_min) & (sv <= 0)) | ((delta >= p.s_max) & (sv >= 0))
    return torch.where(pinned, torch.zeros_like(svc), svc)


def _v_safe(v, eps):
    tiny = torch.where(v < 0, torch.full_like(v, -eps),
                       torch.full_like(v, eps))
    return torch.where(v.abs() < eps, tiny, v)


def st_deriv_cr(x: torch.Tensor, u: torch.Tensor, p: VehicleParams,
                v_switch: float = V_SWITCH_CR,
                v_low: float = V_LOW_CR) -> torch.Tensor:
    """CommonRoad-exact single-track derivative, batched and branchless:
    input constraints applied to (sv, accl), raw (unclipped) states in the
    equations, and the KS-at-CoG fallback with derived (psi_ddot, beta_dot)
    below ``v_low``. ``blended_deriv`` is the simpler v > 3 switch to the
    rear-axle kinematic model."""
    delta = x[..., IDELTA]
    v = x[..., IV]
    psi = x[..., IPSI]
    psi_dot = x[..., IPSIDOT]
    beta = x[..., IBETA]
    sv = steer_constraint(delta, u[..., 1], p)
    accl = accl_constraint(v, u[..., 0], p, v_switch=v_switch)
    wb = p.lf + p.lr

    # --- dynamic ST branch (|v| >= v_low)
    load_f = G * p.lr - accl * p.h
    load_r = G * p.lf + accl * p.h
    v_safe = _v_safe(v, 1e-3)
    psi_ddot = (p.mu * p.m / (p.I * wb)) * (
        p.lf * p.C_Sf * load_f * delta
        + (p.lr * p.C_Sr * load_r - p.lf * p.C_Sf * load_f) * beta
        - (p.lf**2 * p.C_Sf * load_f + p.lr**2 * p.C_Sr * load_r)
        * (psi_dot / v_safe))
    beta_dot = (p.mu / (v_safe * wb)) * (
        p.C_Sf * load_f * delta
        - (p.C_Sr * load_r + p.C_Sf * load_f) * beta
        + (p.C_Sr * load_r * p.lr - p.C_Sf * load_f * p.lf)
        * (psi_dot / v_safe)) - psi_dot
    dyn = torch.stack([v * torch.cos(psi + beta), v * torch.sin(psi + beta),
                       sv, accl, psi_dot, psi_ddot, beta_dot], dim=-1)

    # --- KS-at-CoG branch (|v| < v_low)
    tan_d = torch.tan(delta)
    beta_ks = torch.atan(tan_d * p.lr / wb)
    cos_d2 = torch.cos(delta) ** 2
    d_beta = (p.lr * sv) / (wb * cos_d2 * (1.0 + (tan_d * p.lr / wb) ** 2))
    dd_psi = (1.0 / wb) * (
        accl * torch.cos(beta) * tan_d
        - v * torch.sin(beta) * d_beta * tan_d
        + v * torch.cos(beta) * sv / cos_d2)
    ks = torch.stack([v * torch.cos(psi + beta_ks),
                      v * torch.sin(psi + beta_ks), sv, accl,
                      v * torch.cos(beta_ks) * tan_d / wb, dd_psi, d_beta],
                     dim=-1)
    return torch.where((v.abs() < v_low)[..., None], ks, dyn)


def ks_deriv_cr(x: torch.Tensor, u: torch.Tensor,
                p: VehicleParams) -> torch.Tensor:
    """CommonRoad kinematic single-track (rear-axle reference) with input
    constraints, in the 7-dim layout."""
    delta = x[..., IDELTA]
    v = x[..., IV]
    psi = x[..., IPSI]
    sv = steer_constraint(delta, u[..., 1], p)
    accl = accl_constraint(v, u[..., 0], p)
    zero = torch.zeros_like(v)
    return torch.stack([v * torch.cos(psi), v * torch.sin(psi), sv, accl,
                        (v / (p.lf + p.lr)) * torch.tan(delta), zero, zero],
                       dim=-1)


def st_mixed_deriv(x: torch.Tensor, u: torch.Tensor, p: VehicleParams,
                   v_s: float = 3.0, v_b: float = 0.1) -> torch.Tensor:
    """Tanh-blended kinematic/dynamic single-track derivative, batched.

    The Cartesian NMPC oracle's model: below ``v_s`` a kinematic model with
    sideslip geometry, above it the dynamic single-track, mixed with
    ``w = 0.5 (tanh((v - v_s)/v_b) + 1)`` and then hard-switched at ``v_s``.
    Unsaturated (raw controls and states): this is the solver-side model;
    bounds are the optimizer's business.
    """
    delta = x[..., IDELTA]
    v = x[..., IV]
    psi = x[..., IPSI]
    psi_dot = x[..., IPSIDOT]
    beta = x[..., IBETA]
    accl = u[..., 0]
    sv = u[..., 1]

    wb = p.lf + p.lr
    load_f = G * p.lr - accl * p.h
    load_r = G * p.lf + accl * p.h
    v_safe = _v_safe(v, 1e-2)

    # slow (kinematic-with-sideslip) yaw/yaw-rate/beta derivatives
    tan_d = torch.tan(delta)
    cos_d2 = torch.cos(delta) ** 2
    dyaw_slow = v * torch.cos(beta) * tan_d / wb
    dbeta_slow = (p.lr * sv) / (wb * cos_d2 * (1.0 + (tan_d * p.lr / wb) ** 2))
    dyawrate_slow = (1.0 / wb) * (
        accl * torch.cos(beta) * tan_d
        - v * torch.sin(beta) * tan_d * dbeta_slow
        + v * torch.cos(beta) * sv / cos_d2)

    # fast (dynamic single-track) yaw-rate/beta derivatives
    dyaw_fast = psi_dot
    dyawrate_fast = (
        -p.mu * p.m / (v_safe * p.I * wb)
        * (p.lf**2 * p.C_Sf * load_f + p.lr**2 * p.C_Sr * load_r) * psi_dot
        + p.mu * p.m / (p.I * wb)
        * (p.lr * p.C_Sr * load_r - p.lf * p.C_Sf * load_f) * beta
        + p.mu * p.m / (p.I * wb) * p.lf * p.C_Sf * load_f * delta)
    dbeta_fast = (
        (p.mu / (v_safe**2 * wb)
         * (p.C_Sr * load_r * p.lr - p.C_Sf * load_f * p.lf) - 1.0) * psi_dot
        - p.mu / (v_safe * wb) * (p.C_Sr * load_r + p.C_Sf * load_f) * beta
        + p.mu / (v_safe * wb) * p.C_Sf * load_f * delta)

    w = 0.5 * (torch.tanh((v - v_s) / v_b) + 1.0)
    # mixed model, hard-selected against pure-slow below v_s
    sel = v > v_s
    dyaw = torch.where(sel, w * dyaw_fast + (1 - w) * dyaw_slow, dyaw_slow)
    dyawrate = torch.where(sel, w * dyawrate_fast + (1 - w) * dyawrate_slow,
                           dyawrate_slow)
    dbeta = torch.where(sel, w * dbeta_fast + (1 - w) * dbeta_slow,
                        dbeta_slow)
    return torch.stack([v * torch.cos(psi + beta), v * torch.sin(psi + beta),
                        sv, accl, dyaw, dyawrate, dbeta], dim=-1)


def rollout(x0: torch.Tensor, controls: torch.Tensor, p: VehicleParams,
            deriv_fn=blended_deriv, integrator: str = "euler") -> torch.Tensor:
    """Integrate a control sequence, batched over the leading axes of ``x0``.

    Args:
        x0: initial states ``(..., 7)``
        controls: ``(..., T, 2)``
        integrator: "euler" (reference behavior) or "rk4"
    Returns:
        all states after each step, ``(..., T, 7)``
    """
    if integrator not in ("euler", "rk4"):
        raise ValueError(f"unknown integrator {integrator!r}")
    step = euler_step if integrator == "euler" else rk4_step
    x, states = x0, []
    for t in range(controls.shape[-2]):
        x = step(deriv_fn, x, controls[..., t, :], p)
        states.append(x)
    return torch.stack(states, dim=-2)


def integrate_st(x_and_u: torch.Tensor, params_vec,
                 horizon: int = 5) -> torch.Tensor:
    """Reference-ABI 5-step blended rollout: input rows
    ``[x(7), accl_0..accl_{T-1}, sv_0..sv_{T-1}]`` with the control tail in
    column-major (accl block then sv block) order; returns all states
    ``(batch, T, 7)``."""
    p = as_params(params_vec, x_and_u)
    x0 = x_and_u[..., :ST_STATE_DIM]
    tail = x_and_u[..., ST_STATE_DIM:]
    controls = torch.stack([tail[..., :horizon],
                            tail[..., horizon:2 * horizon]], dim=-1)
    return rollout(x0, controls, p, deriv_fn=blended_deriv,
                   integrator="euler")


def kinematic_onestep(x_u: torch.Tensor, params_vec) -> torch.Tensor:
    """Reference-ABI one-step kinematic Euler update: input rows
    ``[x(7), accl, sv]`` -> next state ``(..., 7)``."""
    p = as_params(params_vec, x_u)
    x = x_u[..., :ST_STATE_DIM]
    u = x_u[..., ST_STATE_DIM:ST_STATE_DIM + 2]
    return x + ks_deriv(x, u, p) * _bcast_dt(p.dt)
