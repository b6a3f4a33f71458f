"""Online planners: learned (IRBFN), solver-in-the-loop (NMPC), adaptive.

Port of ``irbfn_tpu/planning/planner.py``. Every planner is batched over
poses; a plan step is tensor code on the track's device, and a net's forward
is the fused CUDA kernel on the card (``ops/rbf.py``).

- ``IRBFNFrenetPlanner``: curvature and goal-speed lookup on the raceline,
  the exact-reflection mirror, the clamp into the trained grid, the net, the
  un-mirror, and a Frenet rollout of the planned controls.
- ``IRBFNPlanner`` (cartesian): a body-frame lookahead goal, the exact
  mirror on the goal's side, the clamp, the net, and a single-track rollout;
  the steer-rate plan is executed as a steer-angle setpoint by default.
- ``NMPCPlanner`` puts the batched AL/Newton solver in the loop,
  warm-started by a net, by its own previous solution, or from zeros.
- ``stack_net_bank`` evaluates a bank of same-architecture nets on one
  batch; ``AdaptiveIRBFNPlanner`` picks one by EXP3, and
  ``GripAdaptiveFrenetPlanner`` picks each lane's arm and pace from the
  online grip observer (``planning/grip.py``).

``_lookahead_goal`` is also the goal-MPC planner's waypoint lookup
(``planning/goal_planner.py``).
"""

from __future__ import annotations

import copy
from typing import List, NamedTuple, Optional

import torch

from irbfn_tpu_torch.dynamics.frenet import frenet_rollout
from irbfn_tpu_torch.dynamics.params import VehicleParams, f1tenth_params
from irbfn_tpu_torch.dynamics.single_track import rollout as st_rollout
from irbfn_tpu_torch.planning.bandits import EXP3
from irbfn_tpu_torch.sim.track import Track, horizon_goal_speed, interp_wrapped
from irbfn_tpu_torch.solvers.nmpc import (NMPCConfig, NMPCSolution,
                                          solve_nmpc_batch)


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


def _net_out(u):
    """A net's controls: a ``ClusterWCRBFNet`` returns ``(out,
    gate_logits)``; the plan step reads ``out``."""
    return u[0] if isinstance(u, tuple) else u


def frenet_query(ey, delta, vx, vy, vx_goal, wz, epsi, curv,
                 mirror: bool = True):
    """The Frenet net's input ``[ey, delta, vx, vy, vx_goal, wz, epsi,
    curv]`` (..., 8) under the exact reflection: where ``mirror`` and ey <
    -0.05, every lateral quantity flips (ey, delta, vy, wz, epsi, curv), and
    the caller flips the steer-rate block back with the returned ``sign``."""
    if mirror:
        need_m = ey < IRBFNFrenetPlanner.MIRROR_EY_THRESHOLD
    else:
        need_m = torch.zeros_like(ey, dtype=torch.bool)
    sign = torch.where(need_m, -1.0, 1.0).to(ey.dtype)
    q = torch.stack([sign * ey, sign * delta, vx, sign * vy, vx_goal,
                     sign * wz, sign * epsi, sign * curv], dim=-1)
    return q, sign


def _clamp_rows(net_in, bounds):
    if bounds is None:
        return net_in
    return torch.minimum(torch.maximum(net_in, bounds[:, 0]), bounds[:, 1])


class IRBFNPlanner:
    """Cartesian learned planner.

    net input: ``[v, x_g, y_g, t_g, v_g, beta, angv]``, the lookahead goal
    in the body frame, with the exact mirror on ``y_g < 0``; output:
    ``[accl_0..4, sv_0..4]`` (``sv_ind`` is where the steer-rate block
    starts).
    """

    def __init__(self, model: torch.nn.Module, track: Track,
                 dyn_params: Optional[VehicleParams] = None,
                 mirror: bool = False, sv_ind: int = 5,
                 horizon_time: float = 0.5, dtype=torch.float32,
                 input_bounds=None, steer_mode: str = "setpoint",
                 setpoint_frac: float = 0.4, setpoint_gain: float = 10.0,
                 plan_dt: float = 0.1):
        """``model`` maps (B, 7) to (B, 10) and lives on the track's device.
        ``input_bounds``: optional (7, 2) per-dim [lo, hi] of the trained
        grid; queries are clamped into it after mirroring (a state outside
        every region's box would zero the gate and the net's output).

        ``steer_mode``: how the plan's steer-rate sequence is executed. The
        cartesian table has no steer-angle input (every plan starts from
        delta = 0), so executing the raw first rate (``"rate"``) is an
        unstable feedback law: in a steady corner every replan ramps delta
        up from 0 again and the executed angle ratchets past the needed one.
        ``"setpoint"`` (the default, and the one to keep) integrates the
        plan's whole rate sequence into the steer-angle profile the solver
        intended, takes its value at ``setpoint_frac`` of the horizon as a
        steer-angle setpoint and emits ``sv = clip(gain * (setpoint -
        delta), +-sv_max)``. ``plan_dt`` is the table's horizon step."""
        if steer_mode not in ("setpoint", "rate"):
            raise ValueError(f"steer_mode {steer_mode!r}")
        self.model = model
        self.track = track
        self.mirror = mirror
        self.sv_ind = sv_ind
        self.horizon_time = horizon_time
        self.dtype = dtype
        self.device = track.raceline.ss.device
        self.steer_mode = steer_mode
        self.setpoint_frac = setpoint_frac
        self.setpoint_gain = setpoint_gain
        self.plan_dt = plan_dt
        self.p = (dyn_params or f1tenth_params(device=self.device)).to(
            self.device, dtype)
        self.input_bounds = (None if input_bounds is None else
                             torch.as_tensor(input_bounds, dtype=dtype,
                                             device=self.device))
        self.last: Optional[PlanResult] = None

    @torch.no_grad()
    def plan_batch(self, x, y, theta, delta, v, beta, angv) -> PlanResult:
        x, y, theta, delta, v, beta, angv = (
            torch.as_tensor(a, dtype=self.dtype, device=self.device)
            for a in (x, y, theta, delta, v, beta, angv))
        rl, p = self.track.raceline, self.p
        gx, gy, gtheta, gv = _lookahead_goal(rl.points, rl.vxs, rl.yaws, x,
                                             y, v, self.horizon_time)
        # body-frame goal
        dx, dy = gx - x, gy - y
        c, s = torch.cos(-theta), torch.sin(-theta)
        lx = c * dx - s * dy
        ly = s * dx + c * dy
        # wrapped: theta accumulates over laps while the raceline's yaw
        # stays in (-pi, pi]
        ltheta = gtheta - theta
        ltheta = torch.atan2(torch.sin(ltheta), torch.cos(ltheta))
        # the exact single-track mirror: every lateral quantity flips (ly,
        # ltheta, beta, angv; sv on the way out)
        if self.mirror:
            need_m = ly < 0
        else:
            need_m = torch.zeros_like(ly, dtype=torch.bool)
        sign = torch.where(need_m, -1.0, 1.0).to(self.dtype)
        net_in = torch.stack([v, lx, sign * ly, sign * ltheta,
                              gv.to(self.dtype), sign * beta, sign * angv],
                             dim=-1)
        net_in = _clamp_rows(net_in, self.input_bounds)
        u = _net_out(self.model(torch.atleast_2d(net_in)))
        u = u.reshape(net_in.shape[:-1] + u.shape[-1:]).to(self.dtype)
        O = u.shape[-1]
        if self.mirror:  # un-mirror the steer-rate block
            T = O - self.sv_ind
            flip = torch.cat([
                torch.ones(O - T, dtype=u.dtype, device=u.device),
                -torch.ones(T, dtype=u.dtype, device=u.device)])
            u = torch.where(need_m[..., None], u * flip, u)
        controls = torch.stack([u[..., :O // 2], u[..., O // 2:]], dim=-1)
        x0 = torch.stack([x, y, delta, v, theta, angv, beta], dim=-1)
        states = st_rollout(x0, controls, p)
        goal = torch.stack([gx, gy, gtheta, gv], dim=-1).to(self.dtype)
        if self.steer_mode == "setpoint":
            # track the plan's implied steer-angle profile
            d_prof = torch.cumsum(controls[..., 1], dim=-1) * self.plan_dt
            T = d_prof.shape[-1]
            k = min(max(int(round(self.setpoint_frac * T)) - 1, 0), T - 1)
            sv_exec = torch.clamp(
                self.setpoint_gain * (d_prof[..., k] - delta),
                -p.sv_max, p.sv_max)
        else:
            sv_exec = u[..., self.sv_ind]
        res = PlanResult(u[..., 0], sv_exec, controls, states, goal)
        self.last = res
        return res

    def plan(self, obs) -> tuple:
        """Reference obs-dict API: returns (accel, steer_vel) floats."""
        res = self.plan_batch(
            obs["pose_x"], obs["pose_y"], obs["pose_theta"], obs["delta"],
            obs["linear_vel_x"], obs["beta"], obs["ang_vel_z"])
        return float(res.accel), float(res.steer_vel)


class IRBFNFrenetPlanner:
    """Frenet learned planner.

    net input: ``[ey, delta, vx, vy, vx_goal, wz, epsi, curv]`` with the
    ``ey < -0.05`` mirror; output: ``[accl_0..4, sv_0..4]``.

    A ``WCRBFNet`` on the card runs through the fused CUDA kernel. A
    ``ClusterWCRBFNet`` (R = 500 regions of K = 10 kernels under a learned
    softmax gate) has no kernel form: its forward is its module path, plain
    tensor operations on any device, and its ``(out, gate_logits)`` pair is
    read for ``out``.
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
        net_in, sign = frenet_query(ey, delta, vx, vy, vx_goal, wz, epsi,
                                    curv, self.mirror)
        need_m = sign < 0
        net_in = _clamp_rows(net_in, self.input_bounds)
        u = _net_out(self.model(torch.atleast_2d(net_in)))
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


class NMPCPlanner:
    """Solver-in-the-loop planner: the batched AL/Newton solver solves one
    NMPC problem per pose and control step.

    Warm starts, in priority order:
      1. an attached IRBFN net's predicted control sequence (amortized
         optimization: the net proposes, the solver polishes),
      2. the previous solution shifted one step,
      3. zeros.
    """

    def __init__(self, track: Track, params: VehicleParams,
                 cfg: NMPCConfig = NMPCConfig(),
                 warm_start_planner: "IRBFNFrenetPlanner | None" = None):
        """``params``: the solver's internal vehicle model, on the track's
        device; its dtype is the solve's."""
        self.track = track
        self.params = params
        self.cfg = cfg
        self.warm_start_planner = warm_start_planner
        self.device = track.raceline.ss.device
        self.dtype = params.dtype
        self._u_prev = None

    @torch.no_grad()
    def plan_batch(self, s, ey, epsi, delta, vx, vy, wz) -> NMPCSolution:
        s, ey, epsi, delta, vx, vy, wz = (
            torch.as_tensor(a, dtype=self.dtype, device=self.device)
            for a in (s, ey, epsi, delta, vx, vy, wz))
        rl = self.track.raceline
        curv = interp_wrapped(rl.ss, rl.ks, s, rl.length).to(self.dtype)
        vx_goal = horizon_goal_speed(
            rl, s, vx, float(self.cfg.horizon * self.cfg.dt)).to(self.dtype)
        zeros = torch.zeros_like(ey)
        x0 = torch.stack([zeros, ey, delta, vx, vy, wz, epsi], dim=-1)
        goal = torch.stack([zeros] * 3 + [vx_goal] + [zeros] * 3, dim=-1)
        if self.warm_start_planner is not None:
            net_plan = self.warm_start_planner.plan_batch(
                s, ey, epsi, delta, vx, vy, wz)
            u_init = net_plan.pred_controls.to(x0.dtype)
        else:
            u_init = self._u_prev
            if u_init is not None and u_init.shape[:-2] != x0.shape[:-1]:
                u_init = None
        sol = solve_nmpc_batch(x0, goal, curv, self.params, self.cfg,
                               u_init=u_init)
        u = torch.stack([sol.accel, sol.steer_vel], dim=-1)
        # shift the warm start one step forward
        self._u_prev = torch.cat([u[..., 1:, :], u[..., -1:, :]], dim=-2)
        return sol

    def plan(self, obs) -> tuple:
        def t(v):
            return torch.atleast_1d(torch.as_tensor(
                v, dtype=self.dtype, device=self.device))

        s, ey, epsi = self.track.cartesian_to_frenet(
            t(obs["pose_x"]), t(obs["pose_y"]), t(obs["pose_theta"]))
        sol = self.plan_batch(s, ey, epsi, t(obs["delta"]),
                              t(obs["linear_vel_x"]), t(obs["linear_vel_y"]),
                              t(obs["ang_vel_z"]))
        return float(sol.accel[0, 0]), float(sol.steer_vel[0, 0])


def stack_net_bank(model: torch.nn.Module, params_list):
    """A bank of nets evaluated on one batch: returns ``(apply_fn, bank)``,
    where ``apply_fn(bank, x)`` is every arm's output on ``x`` (..., F),
    shape ``(n_arms, ..., O)``; a per-row arm index then gathers the pulled
    arm. Each arm is its own forward over the whole batch (on the card: one
    ``rbf_forward`` kernel forward per arm).

    Every arm is ``model`` (its class, widths and constants: the input
    scale and the region gate) with the parameters of one entry of
    ``params_list`` (modules, or dicts of parameter tensors by name), as in
    the JAX package, whose bank is one module vmapped over stacked
    parameters: an arm fitted with other constants is evaluated with
    ``model``'s (ROADMAP.md, faults, R4)."""
    bank = []
    for params in params_list:
        src = (dict(params.named_parameters())
               if isinstance(params, torch.nn.Module) else params)
        arm = copy.deepcopy(model)
        with torch.no_grad():
            for name, p in arm.named_parameters():
                p.copy_(src[name])
        bank.append(arm.eval())

    @torch.no_grad()
    def apply_fn(bank, x):
        rows = x.reshape(-1, x.shape[-1])
        out = torch.stack([_net_out(m(rows)) for m in bank])
        return out.reshape((len(bank),) + x.shape[:-1] + out.shape[-1:])

    return apply_fn, tuple(bank)


class AdaptiveIRBFNPlanner:
    """EXP3 bandit over a bank of planners trained for different (mu, cs);
    the pulled arm's planner plans."""

    def __init__(self, planners: List, gamma: float = 0.2, seed: int = 0):
        self.planners = planners
        self.bandit = EXP3(len(planners), gamma, seed)
        self.current_arm = 0

    def select(self) -> int:
        self.current_arm = self.bandit.pull_arm()
        return self.current_arm

    def reward(self, r: float):
        self.bandit.update_dist(self.current_arm, r)

    def plan(self, obs):
        return self.planners[self.current_arm].plan(obs)


class GripAdaptiveFrenetPlanner:
    """Grip-adaptive learned planner: a bank of Frenet nets trained at
    different mu (``stack_net_bank``), with the arm AND the pace chosen per
    lane online from the grip observer's estimate g (``planning/grip.py``):

        arm  = argmin_a |arm_mu_a - g|         (nearest trained-mu net)
        pace = clip(sqrt(g) * margin, lo, hi)  (grip-limited cornering speed)

    One policy step: observer update, arm, pace-scaled goal speed, the
    mirrored bank forward and the gather by arm, then the observer's record
    of the action. Use it through ``policy()`` and ``init_state()`` in
    ``TrackEnv.rollout_stateful`` (accl control mode).
    """

    def __init__(self, model: torch.nn.Module, params_list: List, arm_mus,
                 track: Track, input_bounds=None, horizon: int = 5,
                 dyn_params: Optional[VehicleParams] = None,
                 nominal_mu: float = 1.0, nominal_cs: float = 5.0,
                 grip_cfg=None, pace_lo: float = 0.35, pace_hi: float = 1.0,
                 pace_margin: float = 1.0, ctrl_dt: float = 0.1,
                 mirror: bool = True, dtype=torch.float32):
        """``model``, ``params_list``: the bank, as ``stack_net_bank`` takes
        it, on the track's device, the arms in the order of ``arm_mus``
        (ascending)."""
        from irbfn_tpu_torch.planning.grip import (GripConfig, grip_init,
                                                   grip_record, grip_update)

        self.track = track
        self.dtype = dtype
        self.device = track.raceline.ss.device
        self.grip_cfg = grip_cfg or GripConfig()
        self._grip_init = grip_init
        cfg = self.grip_cfg
        rl = track.raceline
        arm_mus = torch.as_tensor(arm_mus, dtype=dtype, device=self.device)
        apply_fn, bank = stack_net_bank(model, params_list)
        self.bank = bank
        # the observer's g = 1 reference: the bank's training nominal
        p_nom = (dyn_params or f1tenth_params(device=self.device)).to(
            self.device, dtype)
        nom = lambda v: torch.tensor(v, dtype=dtype,  # noqa: E731
                                     device=self.device)
        p_nom = p_nom.replace(mu=nom(nominal_mu), C_Sf=nom(nominal_cs),
                              C_Sr=nom(nominal_cs))
        bounds = (None if input_bounds is None else
                  torch.as_tensor(input_bounds, dtype=dtype,
                                  device=self.device))

        @torch.no_grad()
        def policy_step(grip_state, obs):
            grip_state = grip_update(grip_state, obs, cfg, ctrl_dt)
            g = grip_state.g
            g_c = torch.clamp(g, arm_mus[0], arm_mus[-1])
            arm = torch.argmin((arm_mus - g_c[..., None]).abs(), dim=-1)
            pace = torch.clamp(torch.sqrt(g) * pace_margin, pace_lo, pace_hi)
            s, ey, epsi = obs.s, obs.ey, obs.epsi
            vx, vy, wz = obs.linear_vel_x, obs.linear_vel_y, obs.ang_vel_z
            curv = interp_wrapped(rl.ss, rl.ks, s, rl.length)
            vx_goal = horizon_goal_speed(rl, s, vx, horizon * ctrl_dt) * pace
            net_in, sign = frenet_query(ey, obs.delta, vx, vy, vx_goal, wz,
                                        epsi, curv, mirror)
            net_in = _clamp_rows(net_in, bounds)
            out_all = apply_fn(bank, net_in)  # (A, ..., 2T)
            idx = arm[None, ..., None].expand((1,) + arm.shape
                                              + out_all.shape[-1:])
            out = torch.gather(out_all, 0, idx)[0].to(ey.dtype)
            T = out.shape[-1] // 2
            action = torch.stack([out[..., 0], sign * out[..., T]], dim=-1)
            grip_state = grip_record(grip_state, obs, action, p_nom, cfg)
            return action, grip_state

        self._policy_step = policy_step

    def init_state(self, batch_shape=()):
        return self._grip_init(batch_shape, self.grip_cfg, self.dtype,
                               self.device)

    def policy(self):
        """``(grip_state, obs) -> (action, grip_state)`` for
        ``TrackEnv.rollout_stateful``."""
        return self._policy_step
