"""Plain reference of the simulator's vehicle: the single-track model of
the F1TENTH car, dynamic above 3 m/s and kinematic (rear axle) below, its
controls held over a control period of ten RK4 steps of 0.01 s.

State ``[x, y, delta, v, psi, psi_dot, beta]``, control ``[accel,
steer_vel]``; the steer angle, speed and both controls are clipped to the
car's limits inside the derivative. Parameters may be per lane.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

G = 9.81
V_BLEND = 3.0


class Car(NamedTuple):
    mu: torch.Tensor
    cs: torch.Tensor  # front and rear cornering stiffness (equal)
    m: float = 1.0489
    I: float = 0.04712
    lf: float = 0.15875
    lr: float = 0.17145
    h: float = 0.074
    sv_max: float = 3.2
    a_max: float = 9.51
    s_max: float = 0.4189
    v_max: float = 7.0


def _clip(a, lim):
    return torch.clamp(a, -lim, lim)


def derivative(x, u, car: Car, v_blend: float = V_BLEND):
    delta = _clip(x[..., 2], car.s_max)
    v = _clip(x[..., 3], car.v_max)
    psi, psi_dot, beta = x[..., 4], x[..., 5], x[..., 6]
    accl = _clip(u[..., 0], car.a_max)
    sv = _clip(u[..., 1], car.sv_max)
    lf, lr, h, wb = car.lf, car.lr, car.h, car.lf + car.lr
    mu, C = car.mu, car.cs

    # dynamic single track
    load_f = G * lr - accl * h
    load_r = G * lf + accl * h
    tiny = torch.where(v < 0, torch.full_like(v, -1e-3),
                       torch.full_like(v, 1e-3))
    v_safe = torch.where(v.abs() < 1e-3, tiny, v)
    psi_ddot = (mu * car.m / (car.I * wb)) * (
        lf * C * load_f * delta
        + (lr * C * load_r - lf * C * load_f) * beta
        - (lf**2 * C * load_f + lr**2 * C * load_r) * (psi_dot / v_safe))
    beta_dot = (mu / (v_safe * wb)) * (
        C * load_f * delta - (C * load_r + C * load_f) * beta
        + (C * load_r * lr - C * load_f * lf) * (psi_dot / v_safe)
    ) - psi_dot
    dyn = torch.stack([v * torch.cos(psi + beta), v * torch.sin(psi + beta),
                       sv, accl, psi_dot, psi_ddot, beta_dot], dim=-1)

    # kinematic bicycle
    zero = torch.zeros_like(v)
    kin = torch.stack([v * torch.cos(psi), v * torch.sin(psi), sv, accl,
                       (v / wb) * torch.tan(delta), zero, zero], dim=-1)
    return torch.where((v > v_blend)[..., None], dyn, kin)


def rk4(x, u, car: Car, dt: float, v_blend: float = V_BLEND):
    k1 = derivative(x, u, car, v_blend)
    k2 = derivative(x + 0.5 * dt * k1, u, car, v_blend)
    k3 = derivative(x + 0.5 * dt * k2, u, car, v_blend)
    k4 = derivative(x + dt * k3, u, car, v_blend)
    return x + (dt / 6.0) * (k1 + 2.0 * k2 + 2.0 * k3 + k4)


def control_period(x, u, car: Car, substeps: int = 10, dt: float = 0.01,
                   v_blend: float = V_BLEND):
    """The state after one control period with ``u`` held. ``v_blend``
    moves the model's switch: a lane whose speed passes within rounding of
    3 m/s takes either branch in float32, so a check also integrates with
    the switch a hair either side."""
    for _ in range(substeps):
        x = rk4(x, u, car, dt, v_blend)
    return x
