"""Low-level vehicle safety and control between the planner and the
integrator.

Port of ``irbfn_tpu/sim/safety.py``: the lidar beams' geometry against the
car body and the instantaneous time-to-collision (iTTC) check, and the
action modes: ``"accl"`` ([accel, steer_vel] passes through) and
``"speed"`` ([speed, steer] through the reference gym's PID low-level
controller). Every per-beam or per-car branch of the reference is a
branchless tensor expression, batched over leading axes.
"""

from __future__ import annotations

import torch

from irbfn_tpu_torch._device import resolve_device
from irbfn_tpu_torch.dynamics.params import VehicleParams


def beam_geometry(n_beams: int = 64, fov: float = 4.7, width: float = 0.31,
                  lf: float = 0.15875, lr: float = 0.17145,
                  dtype=torch.float32, device=None):
    """Per-beam scan angles, cosines and car-edge offsets, each (n_beams,),
    on ``device`` (None: the card).

    The offset of beam i is the distance from the lidar (at the CoG) to the
    car body's edge along the beam: the reference's four-quadrant branch
    reduces to ``min(half_width / |sin a|, half_length / |cos a|)``, a
    rectangle's support function."""
    device = resolve_device(device)
    angles = (-fov / 2.0 + torch.arange(n_beams, dtype=dtype, device=device)
              * (fov / (n_beams - 1)))
    cosines = torch.cos(angles)
    to_side = (width / 2.0) / torch.clamp(torch.sin(angles).abs(), min=1e-12)
    to_fr = ((lf + lr) / 2.0) / torch.clamp(cosines.abs(), min=1e-12)
    return angles, cosines, torch.minimum(to_side, to_fr)


def ttc_in_collision(scan, vel, cosines, side_distances,
                     ttc_thresh: float = 0.005):
    """Instantaneous time-to-collision check: per beam, iTTC = (range -
    car_edge_offset) / (v cos a); the car is "in collision" if any beam's
    iTTC lies in [0, ttc_thresh). A zero velocity never collides.

    ``scan`` (..., n_beams), ``vel`` (...,); returns (...,) bool."""
    scan = torch.as_tensor(scan)
    vel = torch.as_tensor(vel, dtype=scan.dtype, device=scan.device)[..., None]
    proj_vel = vel * cosines
    still = proj_vel == 0.0
    safe = torch.where(still, torch.ones_like(proj_vel), proj_vel)
    ttc = torch.where(still, torch.full_like(proj_vel, float("inf")),
                      (scan - side_distances) / safe)
    hit = (ttc >= 0.0) & (ttc < ttc_thresh) & (vel != 0.0)
    return torch.any(hit, dim=-1)


def pid_lowlevel(speed, steer, current_speed, current_steer,
                 p: VehicleParams, v_min=None):
    """Speed/steer command -> (accel, steer-vel), the reference gym's
    low-level controller, branchless and batched.

    Steering is bang-bang at sv_max outside a 1e-4 deadband; acceleration is
    proportional with gain 10*a_max/v_max forward (2* in reverse), with the
    braking gain normalised by |v_min|. ``v_min`` defaults to the reference
    gym's -5.0 (VehicleParams carries no v_min field).
    """
    v_min = -5.0 if v_min is None else v_min
    steer_diff = steer - current_steer
    sv = torch.where(steer_diff.abs() > 1e-4,
                     torch.sign(steer_diff) * p.sv_max,
                     torch.zeros_like(steer_diff))
    vel_diff = speed - current_speed
    up = vel_diff > 0.0
    fwd_gain = torch.where(up, 10.0 * p.a_max / p.v_max,
                           10.0 * p.a_max / (-v_min))
    rev_gain = torch.where(up, 2.0 * p.a_max / p.v_max,
                           2.0 * p.a_max / (-v_min))
    accl = torch.where(current_speed > 0.0, fwd_gain, rev_gain) * vel_diff
    return accl, sv


def accl_action(action, state, p: VehicleParams):
    """'accl' control mode: action (..., 2) = [accel, steer_vel] passes
    through (saturation happens inside the dynamics)."""
    del state, p
    return torch.as_tensor(action)


def speed_action(action, state, p: VehicleParams):
    """'speed' control mode: action (..., 2) = [speed, steer] becomes
    [accel, steer_vel] by the PID against the current single-track state
    (v = state[..., 3], steer = state[..., 2])."""
    action = torch.as_tensor(action)
    accl, sv = pid_lowlevel(action[..., 0], action[..., 1],
                            state[..., 3], state[..., 2], p)
    return torch.stack([accl, sv], dim=-1)


ACTION_MODES = {"accl": accl_action, "speed": speed_action}
