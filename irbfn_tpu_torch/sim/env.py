"""Closed-loop track simulator.

Port of ``irbfn_tpu/sim/env.py``: single-track dynamics stepped with
per-lane (mu, cs) vehicle parameters, track-relative observations, lap
counting, noisy resets and batched rollouts, in either action mode of
``sim/safety.py:ACTION_MODES`` (``"accl"``: [accel, steer_vel]; ``"speed"``:
[speed, steer] through the PID). The state is a set of tensors
batched over parallel episodes; a rollout is a Python loop over control
steps. Terminated episodes are frozen in place.

The world is open, a corridor around the raceline, or an occupancy map
(``sim/map.py``): with a map, observations can carry a sphere-traced lidar
scan, and the iTTC check on that scan stops a car before a wall.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from irbfn_tpu_torch.dynamics.params import VehicleParams
from irbfn_tpu_torch.dynamics.single_track import blended_deriv, rk4_step
from irbfn_tpu_torch.sim.safety import ACTION_MODES
from irbfn_tpu_torch.sim.track import Track
from irbfn_tpu_torch.utils import prng


class SimState(NamedTuple):
    x: torch.Tensor  # (..., 7) ST state [x, y, delta, v, psi, psidot, beta]
    t: torch.Tensor  # (...,) sim time
    s: torch.Tensor  # (...,) frenet progress (unwrapped)
    laps: torch.Tensor  # (...,) completed laps, int32
    done: torch.Tensor  # (...,) terminated flag


class Observation(NamedTuple):
    """The fields the planners read; ``scan`` holds lidar ranges (...,
    n_beams) when the env has a scan_spec, else None."""

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
    scan: Optional[torch.Tensor] = None


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
                 car_radius: float = 0.0, control_mode: str = "accl",
                 scan_spec=None, enable_ttc: bool = False,
                 ttc_thresh: float = 0.005,
                 car_footprint: tuple | None = None):
        """``params`` fields may be 0-dim or per lane ``(B,)``.

        ``half_width``: drivable corridor half width around the raceline;
        leaving it terminates the episode. ``occ_map``: a
        ``sim.map.OccupancyMap`` on the params' device; collision is then
        also checked against the map: the distance field under the car's
        disc (``car_radius``), or under its oriented rectangle
        (``car_footprint`` = (length, width), a covering-disc chain). None
        for both = open world.

        ``scan_spec``: a ``sim.map.ScanSpec``; observations then carry lidar
        ranges traced in ``occ_map``. ``enable_ttc``: the iTTC check runs
        every control step on the current scan (the default ScanSpec if none
        is given); a hit stops the car where it stands and terminates the
        episode. Both require ``occ_map``."""
        if control_mode not in ACTION_MODES:
            raise ValueError(f"unknown control_mode {control_mode!r}; "
                             f"one of {sorted(ACTION_MODES)}")
        if (scan_spec is not None or enable_ttc) and occ_map is None:
            raise ValueError("scan_spec/enable_ttc require an occ_map")
        self.track = track
        self.params = params
        self.sim_dt = sim_dt
        self.substeps = max(1, int(round(control_dt / sim_dt)))
        self.half_width = half_width
        self.occ_map = occ_map
        self.car_radius = car_radius
        self.car_footprint = car_footprint
        self.control_mode = control_mode
        self._act = ACTION_MODES[control_mode]
        self._p_sim = params.replace(
            dt=torch.as_tensor(sim_dt, dtype=params.dtype,
                               device=params.dt.device))
        if enable_ttc and scan_spec is None:
            from irbfn_tpu_torch.sim.map import ScanSpec

            scan_spec = ScanSpec()
        self.scan_spec = scan_spec
        self.enable_ttc = enable_ttc
        self.ttc_thresh = ttc_thresh
        if enable_ttc:
            from irbfn_tpu_torch.sim.safety import beam_geometry

            # the f1tenth car's per-beam body-edge offsets
            _, self._ttc_cos, self._ttc_side = beam_geometry(
                n_beams=scan_spec.n_beams, fov=scan_spec.fov,
                dtype=params.dtype, device=params.dt.device)

    def reset(self, s0=0.0, ey0=0.0, speed0=0.1, noise=None,
              noise_scale: float = 0.0, batch_shape=(), key=None) -> SimState:
        """Start on the raceline at arc length s0, plus optional pose noise
        ``noise_scale * noise`` on (x, y, theta). The noise is JAX's draw
        from ``key`` (a ``utils/prng.py`` key): ``noise_scale *
        normal(key, batch_shape + (3,))`` in f32, as the JAX package's
        ``reset(key=...)``; or ``noise``, a tensor of shape ``batch_shape +
        (3,)`` of unit-normal values."""
        p = self.params
        dtype, device = p.dtype, p.dt.device
        s0 = torch.as_tensor(s0, dtype=dtype, device=device).broadcast_to(
            batch_shape)
        ey0 = torch.as_tensor(ey0, dtype=dtype, device=device).broadcast_to(
            batch_shape)
        x, y, theta = self.track.frenet_to_cartesian(s0, ey0,
                                                     torch.zeros_like(s0))
        if noise_scale > 0 and (key is not None or noise is not None):
            if key is not None:
                noise = noise_scale * prng.normal(
                    key.to(device), tuple(batch_shape) + (3,))
            else:
                noise = noise_scale * torch.as_tensor(noise, dtype=dtype,
                                                      device=device)
            noise = noise.to(dtype)
            x = x + noise[..., 0]
            y = y + noise[..., 1]
            theta = theta + noise[..., 2]
        zeros = torch.zeros_like(s0)
        state = torch.stack([x, y, zeros, torch.full_like(s0, speed0), theta,
                             zeros, zeros], dim=-1)
        return SimState(state, zeros, s0, zeros.to(torch.int32),
                        torch.zeros(batch_shape, dtype=torch.bool,
                                    device=device))

    def _scan(self, x):
        from irbfn_tpu_torch.sim.map import trace_rays

        return trace_rays(self.occ_map, x[..., 0], x[..., 1], x[..., 4],
                          self.scan_spec)

    def observe(self, sim: SimState) -> Observation:
        x = sim.x
        s, ey, epsi = self.track.cartesian_to_frenet(x[..., 0], x[..., 1],
                                                     x[..., 4])
        scan = self._scan(x) if self.scan_spec is not None else None
        return Observation(x[..., 0], x[..., 1], x[..., 4], x[..., 2],
                           x[..., 3], x[..., 3] * torch.tan(x[..., 6]),
                           x[..., 5], x[..., 6], s, ey, epsi, scan)

    def step(self, sim: SimState, action, scan=None) -> SimState:
        """Advance one control period: ``substeps`` RK4 steps at sim_dt with
        the action (..., 2) held.

        ``scan``: with enable_ttc, the scan at the current pose (the
        rollouts pass the observation's; traced here if None). An iTTC hit
        stops the car where it stands (speed, yaw rate and slip zeroed, the
        steer angle kept) and terminates the episode."""
        action = torch.as_tensor(action, dtype=sim.x.dtype,
                                 device=sim.x.device)
        ttc_hit = None
        if self.enable_ttc:
            from irbfn_tpu_torch.sim.safety import ttc_in_collision

            if scan is None:
                scan = self._scan(sim.x)
            ttc_hit = ttc_in_collision(scan, sim.x[..., 3], self._ttc_cos,
                                       self._ttc_side, self.ttc_thresh)
        x_new = sim.x
        for _ in range(self.substeps):
            u = self._act(action, x_new, self._p_sim)
            x_new = rk4_step(blended_deriv, x_new, u, self._p_sim)
        if ttc_hit is not None:
            stopped = sim.x.clone()
            stopped[..., [3, 5, 6]] = 0.0
            x_new = torch.where(ttc_hit[..., None], stopped, x_new)
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
        # termination: numerical blow-up, the iTTC stop, off the corridor,
        # or into the map's walls
        crashed = ~torch.all(torch.isfinite(x_new), dim=-1)
        if ttc_hit is not None:
            crashed = crashed | ttc_hit
        if self.half_width is not None:
            crashed = crashed | (ey_new.abs() > self.half_width)
        if self.occ_map is not None:
            from irbfn_tpu_torch.sim.map import (footprint_clearance,
                                                 map_clearance)

            if self.car_footprint is not None:
                length_fp, width_fp = self.car_footprint
                clear = footprint_clearance(
                    self.occ_map, x_new[..., 0], x_new[..., 1],
                    x_new[..., 4], length_fp, width_fp)
            else:
                clear = map_clearance(self.occ_map, x_new[..., 0],
                                      x_new[..., 1], self.car_radius)
            crashed = crashed | (clear < 0)
        t_new = torch.where(sim.done, sim.t,
                            sim.t + self.substeps * self.sim_dt)
        return SimState(x_new, t_new, s_unwrapped, laps, sim.done | crashed)

    def rollout(self, sim: SimState, policy: Callable, n_steps: int):
        """Run ``policy(obs) -> action`` closed loop for n_steps. Returns
        (final SimState, StepRecord trajectory stacked on axis 0)."""
        records = []
        for _ in range(n_steps):
            obs = self.observe(sim)
            sim = self.step(sim, policy(obs), obs.scan)
            records.append(StepRecord(obs, sim.done, sim.laps))
        return sim, _stack_records(records)

    def rollout_stateful(self, sim: SimState, policy: Callable,
                         policy_state, n_steps: int):
        """Closed loop for a stateful policy, ``policy(policy_state, obs) ->
        (action, policy_state)`` (e.g. an online grip observer whose
        estimate rides along). Returns (final SimState, final policy_state,
        StepRecord trajectory stacked on axis 0)."""
        records = []
        for _ in range(n_steps):
            obs = self.observe(sim)
            action, policy_state = policy(policy_state, obs)
            sim = self.step(sim, action, obs.scan)
            records.append(StepRecord(obs, sim.done, sim.laps))
        return sim, policy_state, _stack_records(records)


def _stack_records(records) -> StepRecord:
    obs = Observation(*[None if f[0] is None else torch.stack(f) for f in
                        zip(*[r.obs for r in records])])
    return StepRecord(obs, torch.stack([r.done for r in records]),
                      torch.stack([r.laps for r in records]))


_OBS_TYPES = {
    # the reference's observation_factory presets; frenet_dynamic_state is
    # the surface the Frenet planners consume
    "kinematic_state": ["pose_x", "pose_y", "delta", "linear_vel_x",
                        "pose_theta"],
    "dynamic_state": ["pose_x", "pose_y", "delta", "linear_vel_x",
                      "pose_theta", "ang_vel_z", "beta"],
    "frenet_dynamic_state": ["pose_x", "pose_y", "delta", "linear_vel_x",
                             "linear_vel_y", "pose_theta", "ang_vel_z",
                             "beta", "s", "ey", "epsi"],
}


def observation_factory(obs: Observation, obs_type: str = "original",
                        features=None, sim: SimState | None = None,
                        scan=None) -> dict:
    """Select an observation dict by type, the reference's observation
    factory over this env's batched Observation.

    ``features`` overrides the preset field list (``obs_type="features"``
    requires it); ``"original"`` returns every field. ``sim`` / ``scan``
    add the reference's collision, lap_time, lap_count and scan entries."""
    d = obs._asdict()
    if d.get("scan") is None:  # scanless env: no scan entry
        d.pop("scan", None)
    if sim is not None:
        d["collision"] = sim.done.to(obs.ey.dtype)
        d["lap_time"] = sim.t
        d["lap_count"] = sim.laps
    if scan is not None:
        d["scan"] = scan
    if features is None:
        if obs_type == "features":
            raise ValueError("obs_type='features' requires a features list")
        if obs_type == "original":
            return d
        if obs_type not in _OBS_TYPES:
            raise ValueError(f"Invalid observation type {obs_type}.")
        features = _OBS_TYPES[obs_type]
    missing = [k for k in features if k not in d]
    if missing:
        raise KeyError(f"observation features not available: {missing}")
    return {k: d[k] for k in features}


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
