"""Action modes between the planner and the integrator.

Port of the action modes of ``irbfn_tpu/sim/safety.py``: ``"accl"``
([accel, steer_vel] passes through) and ``"speed"`` ([speed, steer] through
the reference gym's PID low-level controller). The iTTC check is still to
be ported.
"""

from __future__ import annotations

import torch

from irbfn_tpu_torch.dynamics.params import VehicleParams


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
