"""The learned Frenet planner.

Port of ``irbfn_tpu/planning/planner.py:IRBFNFrenetPlanner``. One plan step,
batched over poses: curvature and goal-speed lookup on the raceline, the
exact-reflection mirror, the clamp into the trained grid, the WCRBF net
(whose forward is the fused CUDA kernel on the card), the un-mirror, and a
Frenet rollout of the planned controls.

``_lookahead_goal`` is the goal-MPC planner's waypoint lookup
(``planning/goal_planner.py``). The cartesian, NMPC, adaptive and
grip-adaptive planners are still to be ported.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from irbfn_tpu_torch.dynamics.frenet import frenet_rollout
from irbfn_tpu_torch.dynamics.params import VehicleParams, f1tenth_params
from irbfn_tpu_torch.sim.track import Track, horizon_goal_speed, interp_wrapped


def _lookahead_goal(rl_points, rl_vxs, rl_yaws, x, y, v, horizon_time=0.5,
                    min_lookahead=0.1):
    """Velocity-scaled lookahead waypoint on the raceline: project the pose
    on the (uniformly resampled) raceline's points and walk the arc forward
    by v * horizon_time. Returns (gx, gy, gtheta, gv); the goal speed is the
    closest point's."""
    query = torch.stack(torch.broadcast_tensors(x, y), dim=-1)
    d2 = torch.sum((query[..., None, :] - rl_points) ** 2, dim=-1)
    idx = torch.argmin(d2, dim=-1)
    n = rl_points.shape[0]
    seg = torch.linalg.norm(rl_points[1] - rl_points[0])
    la_d = torch.clamp(torch.clamp(v, min=0.1) * horizon_time,
                       min=min_lookahead)
    steps = torch.ceil(la_d / seg).to(torch.int64)
    goal_idx = torch.remainder(idx + steps, n)
    return (rl_points[goal_idx, 0], rl_points[goal_idx, 1],
            rl_yaws[goal_idx], rl_vxs[idx])


class PlanResult(NamedTuple):
    accel: torch.Tensor  # (...,)
    steer_vel: torch.Tensor  # (...,)
    pred_controls: torch.Tensor  # (..., T, 2) full predicted sequence
    pred_states: torch.Tensor  # (..., T, 7) rollout for visualization
    goal: torch.Tensor  # (..., 4) goal state used


class IRBFNFrenetPlanner:
    """Frenet learned planner.

    net input: ``[ey, delta, vx, vy, vx_goal, wz, epsi, curv]`` with the
    ``ey < -0.05`` mirror; output: ``[accl_0..4, sv_0..4]``.
    """

    MIRROR_EY_THRESHOLD = -0.05

    def __init__(self, model: torch.nn.Module, track: Track,
                 dyn_params: Optional[VehicleParams] = None,
                 mirror: bool = True, horizon: int = 5,
                 dtype=torch.float32, input_bounds=None):
        """``model`` maps (B, 8) to (B, 10) and lives on the track's device.
        ``input_bounds``: optional (8, 2) per-dim [lo, hi] of the trained
        grid; net inputs are clamped into it after mirroring, so off-table
        states degrade to the nearest trained problem."""
        self.model = model
        self.track = track
        self.mirror = mirror
        self.dtype = dtype
        self.device = track.raceline.ss.device
        self.horizon = horizon
        self.p = (dyn_params or f1tenth_params(device=self.device)).to(
            self.device, dtype)
        self.input_bounds = (None if input_bounds is None else
                             torch.as_tensor(input_bounds, dtype=dtype,
                                             device=self.device))
        self.last: Optional[PlanResult] = None

    @torch.no_grad()
    def plan_batch(self, s, ey, epsi, delta, vx, vy, wz) -> PlanResult:
        s, ey, epsi, delta, vx, vy, wz = (
            torch.as_tensor(a, dtype=self.dtype, device=self.device)
            for a in (s, ey, epsi, delta, vx, vy, wz))
        rl, p = self.track.raceline, self.p
        curv = interp_wrapped(rl.ss, rl.ks, s, rl.length)
        vx_goal = horizon_goal_speed(rl, s, vx, self.horizon * p.dt)
        if self.mirror:
            need_m = ey < self.MIRROR_EY_THRESHOLD
        else:
            need_m = torch.zeros_like(ey, dtype=torch.bool)
        sign = torch.where(need_m, -1.0, 1.0).to(self.dtype)
        # exact reflection: every lateral quantity flips (ey, delta, vy, wz,
        # epsi, curv), and the sv block is un-flipped on the way out
        net_in = torch.stack([sign * ey, sign * delta, vx, sign * vy,
                              vx_goal, sign * wz, sign * epsi, sign * curv],
                             dim=-1)
        if self.input_bounds is not None:
            net_in = torch.minimum(
                torch.maximum(net_in, self.input_bounds[:, 0]),
                self.input_bounds[:, 1])
        u = self.model(torch.atleast_2d(net_in))
        u = u.reshape(net_in.shape[:-1] + u.shape[-1:]).to(self.dtype)
        T = u.shape[-1] // 2
        flip = torch.cat([torch.ones(T, dtype=u.dtype, device=u.device),
                          -torch.ones(T, dtype=u.dtype, device=u.device)])
        u = torch.where(need_m[..., None], u * flip, u)
        controls = torch.stack([u[..., :T], u[..., T:]], dim=-1)
        x0 = torch.stack([s, ey, delta, vx, vy, wz, epsi], dim=-1)
        states = frenet_rollout(x0, controls, curv, p, blend="ls")
        zeros = torch.zeros_like(ey)
        goal = torch.stack([zeros, zeros, zeros, vx_goal], dim=-1)
        res = PlanResult(u[..., 0], u[..., T], controls, states, goal)
        self.last = res
        return res

    def plan(self, obs) -> tuple:
        """Reference obs-dict API: returns (accel, steer_vel) floats."""
        s, ey, epsi = self.track.cartesian_to_frenet(
            *(torch.as_tensor(obs[k], dtype=self.dtype, device=self.device)
              for k in ("pose_x", "pose_y", "pose_theta")))
        res = self.plan_batch(s, ey, epsi, obs["delta"],
                              obs["linear_vel_x"], obs["linear_vel_y"],
                              obs["ang_vel_z"])
        return float(res.accel), float(res.steer_vel)
