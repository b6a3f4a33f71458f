"""Multi-agent racing simulation.

Port of ``irbfn_tpu/sim/multi_agent.py``: agents are one more batch axis of
the state, (..., A, 7), and every agent steps in one batched RK4. Pairwise
collision is exact oriented-rectangle overlap by the separating-axis
theorem (for two convex polygons it decides what GJK decides, with no
data-dependent loop); a two-disc proxy remains as
``collision_model="discs"``. With a ``ScanSpec`` every agent's lidar sees
the map and the other cars' footprints, and the iTTC check on that scan
stops an agent before an impact.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from irbfn_tpu_torch.dynamics.params import VehicleParams
from irbfn_tpu_torch.dynamics.single_track import blended_deriv, rk4_step
from irbfn_tpu_torch.sim.track import Track


class MultiAgentState(NamedTuple):
    x: torch.Tensor  # (..., A, 7)
    t: torch.Tensor  # (...,)
    collided: torch.Tensor  # (..., A) sticky collision flags


def footprint_vertices(x, length: float, width: float):
    """Oriented-rectangle corners of each car: (..., A, 4, 2), counter-
    clockwise from front-left."""
    c = x[..., :2]
    th = x[..., 4]
    hl, hw = length / 2.0, width / 2.0
    local = torch.tensor([[hl, hw], [hl, -hw], [-hl, -hw], [-hl, hw]],
                         dtype=c.dtype, device=c.device)  # (4, 2)
    co, si = torch.cos(th), torch.sin(th)
    rot = torch.stack([torch.stack([co, -si], -1),
                       torch.stack([si, co], -1)], dim=-2)  # (..., A, 2, 2)
    return c[..., None, :] + local @ rot.transpose(-1, -2)


def ray_segment_distance(ox, oy, beam_theta, va, vb, eps: float = 1e-12):
    """Distance from (ox, oy) along world-frame angle ``beam_theta`` to the
    segment va -> vb; +inf where the ray misses.

    With the beam normal n = (-sin t, cos t), d1 = cross(vb - va, o - va) /
    ((vb - va) . n) is the range along the beam and d2 = (o - va) . n /
    ((vb - va) . n) the parameter on the segment; a hit needs d1 >= 0 and
    d2 in [0, 1]. A beam exactly along the edge returns inf. All arguments
    broadcast."""
    v1x = ox - va[..., 0]
    v1y = oy - va[..., 1]
    v2x = vb[..., 0] - va[..., 0]
    v2y = vb[..., 1] - va[..., 1]
    n_x = -torch.sin(beam_theta)
    n_y = torch.cos(beam_theta)
    denom = v2x * n_x + v2y * n_y
    ok = denom.abs() > eps
    safe = torch.where(ok, denom, torch.ones_like(denom))
    d1 = (v2x * v1y - v2y * v1x) / safe
    d2 = (v1x * n_x + v1y * n_y) / safe
    valid = ok & (d1 >= 0.0) & (d2 >= 0.0) & (d2 <= 1.0)
    return torch.where(valid, d1, torch.full_like(d1, float("inf")))


def ray_cast_footprints(x, scan, angles, car_length: float = 0.58,
                        car_width: float = 0.31):
    """Shorten each agent's scan by every opponent's rectangle footprint:
    all (scanning agent, beam, opponent, edge) intersections at once, the
    per-beam minimum kept.

    Args:
        x: (..., A, 7) agent states.
        scan: (..., A, B) base scans (map scan, or max range in open space).
        angles: (B,) beam angles relative to each agent's heading.
    Returns:
        (..., A, B) shortened scans.
    """
    verts = footprint_vertices(x, car_length, car_width)  # (..., A, 4, 2)
    # axes of the intersection grid: (..., Ai, B, Aj, 4)
    va = verts[..., None, None, :, :, :]  # (..., 1, 1, Aj, 4, 2)
    vb = torch.roll(verts, -1, dims=-2)[..., None, None, :, :, :]
    ox = x[..., 0][..., None, None, None]  # (..., Ai, 1, 1, 1)
    oy = x[..., 1][..., None, None, None]
    bt = (x[..., :, None, 4] + angles)[..., :, :, None, None]
    d = ray_segment_distance(ox, oy, bt, va, vb)  # (..., Ai, B, Aj, 4)
    n_agents = x.shape[-2]
    eye = torch.eye(n_agents, dtype=torch.bool,
                    device=x.device)[:, None, :, None]  # (Ai, 1, Aj, 1)
    d = torch.where(eye, torch.full_like(d, float("inf")), d)
    return torch.minimum(scan, torch.amin(d, dim=(-1, -2)))


def _disc_centers(x, p: VehicleParams):
    """Two collision discs per car at the axles: (..., A, 2, 2)."""
    pos = x[..., :2]
    psi = x[..., 4]
    heading = torch.stack([torch.cos(psi), torch.sin(psi)], dim=-1)
    front = pos + p.lf * heading
    rear = pos - p.lr * heading
    return torch.stack([front, rear], dim=-2)


def rects_overlap(c1, th1, c2, th2, length: float, width: float):
    """Exact oriented-rectangle overlap by the separating-axis theorem.

    Two rectangles of the same (length, width), centred at c1/c2 (..., 2)
    with headings th1/th2 (...), overlap iff no axis among the four edge
    normals separates their projections. Touching counts as overlap
    (``dist <= r1 + r2``)."""
    half = torch.tensor([length / 2.0, width / 2.0], dtype=c1.dtype,
                        device=c1.device)

    def axes(th):
        c, s = torch.cos(th), torch.sin(th)
        return torch.stack([torch.stack([c, s], -1),
                            torch.stack([-s, c], -1)], dim=-2)

    a1, a2 = torch.broadcast_tensors(axes(th1), axes(th2))
    axes_all = torch.cat([a1, a2], dim=-2)  # (..., 4, 2)
    d = (c2 - c1)[..., None, :]  # (..., 1, 2)
    dist = torch.sum(axes_all * d, dim=-1).abs()  # (..., 4)
    # projection radius of each rectangle on each axis
    r1 = torch.sum(half * (axes_all @ a1.transpose(-1, -2)).abs(), dim=-1)
    r2 = torch.sum(half * (axes_all @ a2.transpose(-1, -2)).abs(), dim=-1)
    return torch.all(dist <= r1 + r2, dim=-1)


def pairwise_collisions(x, p: VehicleParams, car_width: float = 0.31,
                        car_length: float = 0.58,
                        collision_model: str = "rect"):
    """Boolean (..., A) collision flags: ``"rect"`` is the exact SAT test on
    the oriented footprints, ``"discs"`` the two-disc proxy (~10 cm
    conservative at close corners)."""
    n_agents = x.shape[-2]
    eye = torch.eye(n_agents, dtype=torch.bool, device=x.device)
    if collision_model == "rect":
        c = x[..., :2]
        th = x[..., 4]
        hit = rects_overlap(c[..., :, None, :], th[..., :, None],
                            c[..., None, :, :], th[..., None, :],
                            car_length, car_width)
        return torch.any(hit & ~eye, dim=-1)
    discs = _disc_centers(x, p)  # (..., A, 2, 2)
    radius = 0.5 * car_width + 0.1
    a = discs[..., :, None, :, None, :]  # (..., A, 1, 2, 1, 2)
    b = discs[..., None, :, None, :, :]  # (..., 1, A, 1, 2, 2)
    d = torch.linalg.vector_norm(a - b, dim=-1)  # (..., A, A, 2, 2)
    min_d = torch.amin(d, dim=(-1, -2))
    return torch.any((min_d < 2 * radius) & ~eye, dim=-1)


class MultiAgentEnv:
    """An A-agent closed-loop env over a track, batched over leading axes.
    Tensors live on the params' device."""

    def __init__(self, track: Track, params: VehicleParams, n_agents: int,
                 sim_dt: float = 0.01, control_dt: float = 0.1,
                 car_width: float = 0.31, car_length: float = 0.58,
                 collision_model: str = "rect", occ_map=None,
                 scan_spec=None, enable_ttc: bool = False,
                 ttc_thresh: float = 0.005):
        """``scan_spec`` (``sim.map.ScanSpec``) adds per-agent lidar to
        ``observe``: the map scan (sphere-traced on ``occ_map``, or max
        range in open space without one) shortened by every opponent's
        footprint. ``enable_ttc`` applies the per-agent iTTC emergency stop
        in ``step`` on those scans."""
        self.track = track
        self.params = params
        self.n_agents = n_agents
        self.car_width = car_width
        self.car_length = car_length
        self.collision_model = collision_model
        self.substeps = max(1, int(round(control_dt / sim_dt)))
        dtype, device = params.dtype, params.dt.device
        self._p_sim = params.replace(
            dt=torch.as_tensor(sim_dt, dtype=dtype, device=device))
        self.occ_map = occ_map
        if enable_ttc and scan_spec is None:
            from irbfn_tpu_torch.sim.map import ScanSpec

            scan_spec = ScanSpec()
        self.scan_spec = scan_spec
        self.enable_ttc = enable_ttc
        self.ttc_thresh = ttc_thresh
        if scan_spec is not None:
            from irbfn_tpu_torch.sim.map import linspace

            self._angles = linspace(-scan_spec.fov / 2, scan_spec.fov / 2,
                                    scan_spec.n_beams, torch.float32, device)
        if enable_ttc:
            from irbfn_tpu_torch.sim.safety import beam_geometry

            _, self._ttc_cos, self._ttc_side = beam_geometry(
                n_beams=scan_spec.n_beams, fov=scan_spec.fov,
                width=car_width, lf=car_length / 2.0, lr=car_length / 2.0,
                dtype=dtype, device=device)

    def reset(self, s0, ey0=None, speed0=0.5,
              batch_shape=()) -> MultiAgentState:
        """s0: per-agent start arc lengths (A,) (a staggered grid start)."""
        dtype, device = self.params.dtype, self.params.dt.device
        shape = tuple(batch_shape) + (self.n_agents,)
        s0 = torch.as_tensor(s0, dtype=dtype, device=device).broadcast_to(
            shape)
        ey0 = (torch.zeros_like(s0) if ey0 is None else torch.as_tensor(
            ey0, dtype=dtype, device=device).broadcast_to(shape))
        x, y, th = self.track.frenet_to_cartesian(s0, ey0,
                                                  torch.zeros_like(s0))
        zeros = torch.zeros_like(s0)
        state = torch.stack([x, y, zeros, torch.full_like(s0, speed0), th,
                             zeros, zeros], dim=-1)
        return MultiAgentState(
            state, torch.zeros(batch_shape, dtype=dtype, device=device),
            torch.zeros(shape, dtype=torch.bool, device=device))

    def scan(self, x):
        """Per-agent lidar (..., A, n_beams): the map scan (max range in
        open space without an occ_map) shortened by opponents'
        footprints."""
        spec = self.scan_spec
        if self.occ_map is not None:
            from irbfn_tpu_torch.sim.map import trace_rays

            base = trace_rays(self.occ_map, x[..., 0], x[..., 1], x[..., 4],
                              spec)
        else:
            base = torch.full(x.shape[:-1] + (spec.n_beams,),
                              spec.max_range, dtype=x.dtype, device=x.device)
        return ray_cast_footprints(x, base, self._angles, self.car_length,
                                   self.car_width)

    def step(self, state: MultiAgentState, actions,
             scan=None) -> MultiAgentState:
        """actions (..., A, 2); collided agents freeze.

        With ``enable_ttc``, an agent whose scan shows an imminent impact
        (an opponent or a wall) stops where it stands and its collided flag
        sticks. ``scan``: the observation's scan (traced here if None)."""
        actions = torch.as_tensor(actions, dtype=state.x.dtype,
                                  device=state.x.device)
        ttc_hit = None
        if self.enable_ttc:
            from irbfn_tpu_torch.sim.safety import ttc_in_collision

            if scan is None:
                scan = self.scan(state.x)
            ttc_hit = ttc_in_collision(scan, state.x[..., 3], self._ttc_cos,
                                       self._ttc_side, self.ttc_thresh)
        x_new = state.x
        for _ in range(self.substeps):
            x_new = rk4_step(blended_deriv, x_new, actions, self._p_sim)
        if ttc_hit is not None:
            stopped = state.x.clone()
            stopped[..., [3, 5, 6]] = 0.0
            x_new = torch.where(ttc_hit[..., None], stopped, x_new)
        x_new = torch.where(state.collided[..., None], state.x, x_new)
        collided = state.collided | pairwise_collisions(
            x_new, self.params, self.car_width, self.car_length,
            self.collision_model)
        if ttc_hit is not None:
            collided = collided | ttc_hit
        return MultiAgentState(
            x_new, state.t + self.substeps * float(self._p_sim.dt), collided)

    def observe(self, state: MultiAgentState) -> dict:
        """Per-agent Frenet observations (s, ey, epsi), the raw states, the
        opponents' relative positions, and with a scan_spec the
        agent-aware lidar."""
        x = state.x
        s, ey, epsi = self.track.cartesian_to_frenet(x[..., 0], x[..., 1],
                                                     x[..., 4])
        rel = x[..., None, :, :2] - x[..., :, None, :2]  # (..., A, A, 2)
        out = {"s": s, "ey": ey, "epsi": epsi, "states": x,
               "opponent_offsets": rel, "collided": state.collided}
        if self.scan_spec is not None:
            out["scan"] = self.scan(x)
        return out


__all__ = ["MultiAgentEnv", "MultiAgentState", "footprint_vertices",
           "pairwise_collisions", "ray_cast_footprints",
           "ray_segment_distance", "rects_overlap"]
