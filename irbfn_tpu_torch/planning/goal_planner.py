"""Goal-MPC planner: waypoint-following speed/steer control.

Port of ``irbfn_tpu/planning/goal_planner.py``. One plan step, batched over
poses:

    pose -> velocity-scaled raceline lookahead (planner.py:_lookahead_goal)
         -> body-frame goal (x_g, y_g, t_g) + v_car, v_goal
         -> y >= 0 mirror (the goal grid covers y_goal in [0, 4] only; the
            kinematic bicycle is laterally symmetric: flip y_g and t_g,
            negate the steer on the way out)
         -> (speed, steer) from the batched ADMM solve (one kernel launch on
            the card for all poses) or from one WCRBF net forward

The outputs feed ``TrackEnv(control_mode="speed")``.
"""

from __future__ import annotations

from typing import Optional

import torch

from irbfn_tpu_torch.planning.planner import _lookahead_goal
from irbfn_tpu_torch.sim.track import Track, wrap_angle
from irbfn_tpu_torch.solvers.goal_mpc import GoalMPCConfig, solve_goal_mpc


class GoalMPCPlanner:
    """Waypoint-following goal-MPC planner (solver- or net-backed).

    ``model`` None: every plan is a live batched ADMM solve with ``iters``
    sweeps. Otherwise ``model`` is a net mapping (B, 5) goal rows to
    (B, 2) [speed, steer] (a ``WCRBFNet`` such as ``goal_mpc_pr``, whose
    forward is the RBF kernel on the card), on the track's device.
    """

    def __init__(self, track: Track, model: Optional[torch.nn.Module] = None,
                 cfg: GoalMPCConfig = GoalMPCConfig(),
                 horizon_time: Optional[float] = None, iters: int = 600):
        self.cfg = cfg
        self.model = model
        self.iters = iters
        # default lookahead: the MPC horizon's preview (T * dt = 0.4 s)
        self.horizon_time = (cfg.horizon * cfg.dt if horizon_time is None
                             else horizon_time)
        self.raceline = track.raceline
        self.rl_points = torch.stack([track.raceline.xs, track.raceline.ys],
                                     dim=-1)

    @torch.no_grad()
    def plan_batch(self, x, y, theta, v):
        """(speed, steer) actions for TrackEnv(control_mode='speed'), in the
        poses' dtype (promoted with the raceline's)."""
        rl = self.raceline
        x, y, theta, v = (torch.as_tensor(a, device=rl.xs.device)
                          for a in (x, y, theta, v))
        gx, gy, gtheta, gv = _lookahead_goal(self.rl_points, rl.vxs, rl.yaws,
                                             x, y, v, self.horizon_time)
        dx, dy = gx - x, gy - y
        co, si = torch.cos(theta), torch.sin(theta)
        xg_b = co * dx + si * dy
        yg_b = -si * dx + co * dy
        tg_b = wrap_angle(gtheta - theta)
        # y >= 0 mirror (the goal grid's half)
        sign = torch.where(yg_b < 0.0, -1.0, 1.0).to(yg_b.dtype)
        cols = torch.broadcast_tensors(v, xg_b, sign * yg_b, sign * tg_b, gv)
        dtype = torch.result_type(cols[0], cols[1])
        inputs = torch.stack([c.to(dtype) for c in cols], dim=-1)
        if self.model is None:
            sol = solve_goal_mpc(inputs.reshape(-1, 5), self.cfg,
                                 iters=self.iters)
            speed, steer = sol.speed, sol.steer
        else:
            net_dtype = next(self.model.parameters()).dtype
            out = self.model(inputs.reshape(-1, 5).to(net_dtype)).to(dtype)
            speed, steer = out[..., 0], out[..., 1]
        speed = speed.reshape(v.shape)
        steer = steer.reshape(v.shape)
        return speed, sign.reshape(v.shape) * steer

    def plan(self, obs):
        """Observation-NamedTuple single-step ABI."""
        return self.plan_batch(obs.pose_x, obs.pose_y, obs.pose_theta,
                               obs.linear_vel_x)
