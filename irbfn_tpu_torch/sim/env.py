"""Closed-loop track simulator.

Port of ``irbfn_tpu/sim/env.py``: single-track dynamics stepped with
per-lane (mu, cs) vehicle parameters, track-relative observations, lap
counting, noisy resets and batched rollouts, in either action mode of
``sim/safety.py:ACTION_MODES`` (``"accl"``: [accel, steer_vel]; ``"speed"``:
[speed, steer] through the PID). The state is a set of tensors
batched over parallel episodes; a rollout is a Python loop over control
steps. Terminated episodes are frozen in place.

Occupancy maps, lidar scans and the iTTC check are still to be ported.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from irbfn_tpu_torch.dynamics.params import VehicleParams
from irbfn_tpu_torch.dynamics.single_track import blended_deriv, rk4_step
from irbfn_tpu_torch.sim.safety import ACTION_MODES
from irbfn_tpu_torch.sim.track import Track

_NOT_PORTED = ("still to be ported (ROADMAP.md, 'Modules to port', item 11:"
               " the rest of the sim)")


class SimState(NamedTuple):
    x: torch.Tensor  # (..., 7) ST state [x, y, delta, v, psi, psidot, beta]
    t: torch.Tensor  # (...,) sim time
    s: torch.Tensor  # (...,) frenet progress (unwrapped)
    laps: torch.Tensor  # (...,) completed laps, int32
    done: torch.Tensor  # (...,) terminated flag


class Observation(NamedTuple):
    pose_x: torch.Tensor
    pose_y: torch.Tensor
    pose_theta: torch.Tensor
    delta: torch.Tensor
    linear_vel_x: torch.Tensor
    linear_vel_y: torch.Tensor
    ang_vel_z: torch.Tensor
    beta: torch.Tensor
    s: torch.Tensor
    ey: torch.Tensor
    epsi: torch.Tensor


class StepRecord(NamedTuple):
    """Per-step rollout record, stacked over steps on axis 0: the
    observation the policy saw, the post-step termination flag and laps."""

    obs: Observation
    done: torch.Tensor
    laps: torch.Tensor


class TrackEnv:
    """Closed-loop env, batched over the leading axes of its state."""

    def __init__(self, track: Track, params: VehicleParams,
                 sim_dt: float = 0.01, control_dt: float = 0.1,
                 half_width: float | None = None, occ_map=None,
                 control_mode: str = "accl", scan_spec=None,
                 enable_ttc: bool = False):
        """``params`` fields may be 0-dim or per lane ``(B,)``.
        ``half_width``: drivable corridor half width around the raceline;
        leaving it terminates the episode. None = open world."""
        if occ_map is not None:
            raise NotImplementedError(f"occ_map is {_NOT_PORTED}")
        if scan_spec is not None:
            raise NotImplementedError(f"scan_spec is {_NOT_PORTED}")
        if enable_ttc:
            raise NotImplementedError(f"enable_ttc is {_NOT_PORTED}")
        if control_mode not in ACTION_MODES:
            raise ValueError(f"unknown control_mode {control_mode!r}; "
                             f"one of {sorted(ACTION_MODES)}")
        self.track = track
        self.params = params
        self.sim_dt = sim_dt
        self.substeps = max(1, int(round(control_dt / sim_dt)))
        self.half_width = half_width
        self.control_mode = control_mode
        self._act = ACTION_MODES[control_mode]
        self._p_sim = params.replace(
            dt=torch.as_tensor(sim_dt, dtype=params.dtype,
                               device=params.dt.device))

    def reset(self, s0=0.0, ey0=0.0, speed0=0.1, noise=None,
              noise_scale: float = 0.0, batch_shape=()) -> SimState:
        """Start on the raceline at arc length s0, plus optional pose noise
        ``noise_scale * noise`` on (x, y, theta). ``noise`` is a tensor of
        shape ``batch_shape + (3,)`` of unit-normal draws, or a
        ``torch.Generator`` to draw them with."""
        p = self.params
        dtype, device = p.dtype, p.dt.device
        s0 = torch.as_tensor(s0, dtype=dtype, device=device).broadcast_to(
            batch_shape)
        ey0 = torch.as_tensor(ey0, dtype=dtype, device=device).broadcast_to(
            batch_shape)
        x, y, theta = self.track.frenet_to_cartesian(s0, ey0,
                                                     torch.zeros_like(s0))
        if noise is not None and noise_scale > 0:
            if isinstance(noise, torch.Generator):
                noise = torch.randn(tuple(batch_shape) + (3,),
                                    generator=noise, dtype=dtype,
                                    device=noise.device).to(device)
            noise = noise_scale * torch.as_tensor(noise, dtype=dtype,
                                                  device=device)
            x = x + noise[..., 0]
            y = y + noise[..., 1]
            theta = theta + noise[..., 2]
        zeros = torch.zeros_like(s0)
        state = torch.stack([x, y, zeros, torch.full_like(s0, speed0), theta,
                             zeros, zeros], dim=-1)
        return SimState(state, zeros, s0, zeros.to(torch.int32),
                        torch.zeros(batch_shape, dtype=torch.bool,
                                    device=device))

    def observe(self, sim: SimState) -> Observation:
        x = sim.x
        s, ey, epsi = self.track.cartesian_to_frenet(x[..., 0], x[..., 1],
                                                     x[..., 4])
        return Observation(x[..., 0], x[..., 1], x[..., 4], x[..., 2],
                           x[..., 3], x[..., 3] * torch.tan(x[..., 6]),
                           x[..., 5], x[..., 6], s, ey, epsi)

    def step(self, sim: SimState, action) -> SimState:
        """Advance one control period: ``substeps`` RK4 steps at sim_dt with
        the action (..., 2) held."""
        action = torch.as_tensor(action, dtype=sim.x.dtype,
                                 device=sim.x.device)
        x_new = sim.x
        for _ in range(self.substeps):
            u = self._act(action, x_new, self._p_sim)
            x_new = rk4_step(blended_deriv, x_new, u, self._p_sim)
        # terminated episodes are frozen: no further integration or progress
        x_new = torch.where(sim.done[..., None], sim.x, x_new)
        s_new, ey_new, _ = self.track.cartesian_to_frenet(
            x_new[..., 0], x_new[..., 1], x_new[..., 4])
        # lap detection: wrapped progress jumps backwards by ~track length
        length = self.track.raceline.length
        ds = s_new - torch.remainder(sim.s, length)
        lap = (ds < -0.5 * length) & ~sim.done
        laps = sim.laps + lap.to(torch.int32)
        s_unwrapped = torch.where(lap, sim.s + ds + length, sim.s + ds)
        s_unwrapped = torch.where(sim.done, sim.s, s_unwrapped)
        # termination: numerical blow-up or off the corridor
        crashed = ~torch.all(torch.isfinite(x_new), dim=-1)
        if self.half_width is not None:
            crashed = crashed | (ey_new.abs() > self.half_width)
        t_new = torch.where(sim.done, sim.t,
                            sim.t + self.substeps * self.sim_dt)
        return SimState(x_new, t_new, s_unwrapped, laps, sim.done | crashed)

    def rollout(self, sim: SimState, policy: Callable, n_steps: int):
        """Run ``policy(obs) -> action`` closed loop for n_steps. Returns
        (final SimState, StepRecord trajectory stacked on axis 0)."""
        records = []
        for _ in range(n_steps):
            obs = self.observe(sim)
            sim = self.step(sim, policy(obs))
            records.append(StepRecord(obs, sim.done, sim.laps))
        return sim, _stack_records(records)


def _stack_records(records) -> StepRecord:
    obs = Observation(*[torch.stack(f) for f in
                        zip(*[r.obs for r in records])])
    return StepRecord(obs, torch.stack([r.done for r in records]),
                      torch.stack([r.laps for r in records]))


def deviation_metrics(traj):
    """Mean absolute lateral / heading deviation over a trajectory.

    Accepts a StepRecord (masks steps after episode termination) or a bare
    Observation trajectory (averages every step)."""
    if isinstance(traj, StepRecord):
        obs, done = traj.obs, traj.done
        # obs[t] was observed BEFORE step t; it is live iff the episode had
        # not terminated by the end of step t-1
        alive = torch.cat([torch.ones_like(done[:1]), ~done[:-1]], dim=0)
        w = alive.to(obs.ey.dtype)
        n = torch.clamp(w.sum(0), min=1.0)
        return ((obs.ey.abs() * w).sum(0) / n,
                (obs.epsi.abs() * w).sum(0) / n)
    return traj.ey.abs().mean(0), traj.epsi.abs().mean(0)
