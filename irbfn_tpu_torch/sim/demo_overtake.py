"""Two-car overtake demo: an ego car running the lattice planner (goal grid
-> clothoid spirals -> obstacle-aware selection) passes a slower lead car
that follows the raceline by pure pursuit, with exact SAT rectangle
collision checks every physics step.

Port of ``scripts/demo_overtake.py``, with its flags, plus ``--device``.
The ego plans in oracle mode (``solvers/clothoid.py:solve_g1_lattice`` on
the 8 x 9 x 5 = 360-goal grid, obstacle radius 0.8) from the lead's true
axle discs, or with ``--from_scan`` from its own agent-aware lidar. The
rollout is a host loop: each control step is ``control(x, s, scan)`` for
both cars, then one ``MultiAgentEnv.step``.

``run(args)`` drives the episode and returns the trajectory and the
outcome; the figure is drawn after it (matplotlib).

Usage: ``python -m irbfn_tpu_torch.sim.demo_overtake [--n_steps 300]
[--from_scan] [--out torch_runs/overtake_demo.png] [--device cpu]``
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from irbfn_tpu_torch._device import resolve_device, wait_clock
from irbfn_tpu_torch.dynamics.params import f1tenth_params
from irbfn_tpu_torch.planning.lattice import (plan_lattice,
                                              sample_lookahead_grid)
from irbfn_tpu_torch.sim.multi_agent import MultiAgentEnv
from irbfn_tpu_torch.sim.safety import pid_lowlevel
from irbfn_tpu_torch.sim.track import (frenet_to_cartesian, interp_wrapped,
                                       oval_track)
from irbfn_tpu_torch.solvers.clothoid import solve_g1_lattice

OBSTACLE_RADIUS = 0.8
BLOCKED_COST = 200.0  # a best plan above this cost follows at the lead's pace


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--map_dir", type=str, default=None)
    p.add_argument("--n_steps", type=int, default=300)
    p.add_argument("--ego_speed_scale", type=float, default=0.85)
    p.add_argument("--lead_speed_scale", type=float, default=0.45)
    p.add_argument("--gap", type=float, default=6.0,
                   help="initial ego deficit behind the lead [m]")
    p.add_argument("--lookahead", type=float, default=7.0)
    p.add_argument("--grid", type=int, nargs=3, default=[8, 9, 5],
                   help="lattice goal grid (n_lon, n_lat, n_theta)")
    p.add_argument("--out", type=str, default="torch_runs/overtake_demo.png")
    p.add_argument("--from_scan", action="store_true",
                   help="plan from the ego's own lidar (agent-aware scan) "
                        "instead of the opponent's privileged pose: scan "
                        "hits become the lattice planner's obstacle points")
    p.add_argument("--n_beams", type=int, default=64)
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: the card)")
    return p.parse_args(argv)


def _to_local(psi, dx, dy):
    """World-frame offsets -> body frame (rotation by -psi)."""
    c, s = torch.cos(psi), torch.sin(psi)
    return c * dx + s * dy, -s * dx + c * dy


def make_control(args, track, params, goals, scan_spec=None):
    """The per-step control law of both cars, ``control(x, s, scan=None)``:
    x (2, 7) agent states [ego, lead], s (2,) their arc lengths, scan (2,
    n_beams) with ``--from_scan`` -> (2, 2) [accel, steer_vel]."""
    rl = track.raceline
    wheelbase = float(params.lf + params.lr)
    if scan_spec is not None:
        from irbfn_tpu_torch.sim.map import linspace

        scan_angles = linspace(-scan_spec.fov / 2, scan_spec.fov / 2,
                               scan_spec.n_beams, torch.float32,
                               goals.device)

    def pursuit(px, py, psi, s, lookahead, speed_scale):
        """Pure-pursuit steer and raceline speed toward s + lookahead."""
        s_t = s + lookahead
        tx, ty, _ = frenet_to_cartesian(rl, s_t, torch.zeros_like(s_t),
                                        torch.zeros_like(s_t))
        lx, ly = _to_local(psi, tx - px, ty - py)
        kappa = 2.0 * ly / torch.clamp(lx * lx + ly * ly, min=1e-3)
        steer = torch.arctan(wheelbase * kappa)
        v_goal = interp_wrapped(rl.ss, rl.vxs, s_t, rl.length) * speed_scale
        return steer, v_goal

    def control(x, s_agents, scan=None):
        px, py, delta, v, psi = (x[:, 0], x[:, 1], x[:, 2], x[:, 3],
                                 x[:, 4])
        # lead (agent 1): pure pursuit on the raceline at a reduced pace
        la_lead = torch.clamp(0.6 * v[1], min=1.5)
        steer_l, v_l = pursuit(px[1], py[1], psi[1], s_agents[1], la_lead,
                               args.lead_speed_scale)

        # ego (agent 0): a lattice plan toward the raceline lookahead
        # point, around the lead, in the ego frame
        s_t = s_agents[0] + args.lookahead
        zero = torch.zeros_like(s_t)
        tx, ty, _ = frenet_to_cartesian(rl, s_t, zero, zero)
        target = torch.stack(_to_local(psi[0], tx - px[0], ty - py[0]))
        if scan is not None and scan_spec is not None:
            # the ego's lidar returns (the lead's footprint included) as
            # obstacle points; open-space beams parked far away
            r = scan[0]
            hit = r < scan_spec.max_range * 0.99
            pts = torch.stack([r * torch.cos(scan_angles),
                               r * torch.sin(scan_angles)], dim=-1)
            obstacles = torch.where(hit[:, None], pts,
                                    torch.full_like(pts, 1e6))
        else:
            # privileged: the lead's true axle discs
            hx, hy = torch.cos(psi[1]), torch.sin(psi[1])
            discs = torch.stack([
                torch.stack([px[1] + params.lf * hx, py[1] + params.lf * hy]),
                torch.stack([px[1] - params.lr * hx,
                             py[1] - params.lr * hy])])  # (2, 2)
            ox, oy = _to_local(psi[0], discs[:, 0] - px[0],
                               discs[:, 1] - py[0])
            obstacles = torch.stack([ox, oy], dim=-1)
        plan = plan_lattice(solve_g1_lattice, goals, target,
                            obstacle_xy=obstacles, n_path_points=9,
                            obstacle_radius=OBSTACLE_RADIUS)
        # the hard-argmin path by pure pursuit on an early point (the
        # softargmin can blend +-y detours into the car)
        pt = plan.argmin_path[3, :2]
        kappa = 2.0 * pt[1] / torch.clamp(pt[0] ** 2 + pt[1] ** 2, min=1e-3)
        steer_e = torch.arctan(wheelbase * kappa)
        v_e = (interp_wrapped(rl.ss, rl.vxs, s_t, rl.length)
               * args.ego_speed_scale)
        # every candidate blocked: follow at the lead's pace
        blocked = plan.costs[torch.argmin(plan.costs)] > BLOCKED_COST
        v_e = torch.where(blocked, 0.8 * v[1], v_e)

        steer = torch.stack([steer_e, steer_l])
        v_cmd = torch.stack([v_e, v_l])
        accl, sv = pid_lowlevel(v_cmd, steer, v, delta, params)
        return torch.stack([accl, sv], dim=-1)

    return control


def make_episode(args, device):
    """``(track, omap, env, state0, control)`` for the flags."""
    omap = None
    if args.map_dir:
        from irbfn_tpu_torch.sim.map import load_track_bundle

        track, omap = load_track_bundle(args.map_dir, device=device)
    else:
        track = oval_track(length=40.0, width=20.0, n_samples=512,
                           speed=4.0, device=device)
    params = f1tenth_params(dtype=torch.float32, device=device)
    scan_spec = None
    if args.from_scan:
        from irbfn_tpu_torch.sim.map import ScanSpec

        scan_spec = ScanSpec(n_beams=args.n_beams, fov=4.7)
    env = MultiAgentEnv(track, params, n_agents=2, collision_model="rect",
                        occ_map=omap if args.from_scan else None,
                        scan_spec=scan_spec)
    goals = sample_lookahead_grid(args.lookahead, half_width=1.2,
                                  n_lon=args.grid[0], n_lat=args.grid[1],
                                  n_theta=args.grid[2], theta_range=0.5,
                                  device=device)
    control = make_control(args, track, params, goals, scan_spec)
    state0 = env.reset(s0=torch.tensor([0.0, args.gap]), speed0=1.0)
    return track, omap, env, state0, control


def outcome(traj_s: np.ndarray, traj_hit: np.ndarray, length: float):
    """The overtake step (the first at which the ego leads by 0.5 m, or
    None), the first collision step (or None), and the final margin (lead
    minus ego arc length; negative: the ego is ahead)."""
    s_unwrap = traj_s + length * np.cumsum(
        np.vstack([np.zeros((1, 2)), np.diff(traj_s, axis=0) < -length / 2]),
        axis=0)
    lead_margin = s_unwrap[:, 1] - s_unwrap[:, 0]
    passed = np.nonzero(lead_margin < -0.5)[0]
    hit_steps = np.nonzero(traj_hit.any(axis=1))[0]
    return dict(overtake_step=int(passed[0]) if passed.size else None,
                collision_step=int(hit_steps[0]) if hit_steps.size else None,
                final_margin=float(lead_margin[-1]))


def run(args) -> dict:
    """Drive the two cars for ``n_steps`` control steps; print and return
    the trajectory (x (T, 2, 7), s (T, 2), collided (T, 2)) and the
    outcome."""
    device = resolve_device(args.device)
    track, omap, env, st, control = make_episode(args, device)
    xs, ss, hits = [], [], []
    t0 = wait_clock(device)
    for _ in range(args.n_steps):
        obs = env.observe(st)
        actions = control(st.x, obs["s"], obs.get("scan"))
        st = env.step(st, actions)
        xs.append(st.x)
        ss.append(obs["s"])
        hits.append(st.collided)
    traj_x = torch.stack(xs).cpu().numpy()
    traj_s = torch.stack(ss).cpu().numpy()
    traj_hit = torch.stack(hits).cpu().numpy()
    wall = wait_clock(device) - t0
    print(f"{args.n_steps} control steps (2 agents) in {wall:.2f}s wall "
          f"({args.n_steps * 0.1 / wall:.1f}x realtime)")
    res = outcome(traj_s, traj_hit, float(track.raceline.length))
    collided = res["collision_step"] is not None
    if collided:
        print(f"COLLISION at step {res['collision_step']}")
    if res["overtake_step"] is not None and not collided:
        k = res["overtake_step"]
        print(f"OVERTAKE COMPLETE at step {k} (t={k * 0.1:.1f}s): ego "
              f"closed a {args.gap:.1f} m gap and leads by "
              f"{-res['final_margin']:.1f} m at the end")
    else:
        print(f"no overtake: final margin {res['final_margin']:.1f} m "
              "(positive = lead still ahead)")
    return dict(res, collided=collided, traj_x=traj_x, traj_s=traj_s,
                traj_hit=traj_hit, wall=wall,
                ms_per_step=1e3 * wall / max(args.n_steps, 1), track=track,
                omap=omap)


def draw(out: dict, args, path: str):
    """Both cars' paths over the track, the overtake point starred."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from irbfn_tpu_torch.sim.render import draw_map, draw_track

    traj_x = out["traj_x"]
    fig, ax = plt.subplots(figsize=(9, 7))
    if out["omap"] is not None:
        draw_map(ax, out["omap"])
    draw_track(ax, out["track"])
    ax.plot(traj_x[:, 1, 0], traj_x[:, 1, 1], color="tab:orange", lw=1.5,
            label="lead (pursuit, slow)")
    ax.plot(traj_x[:, 0, 0], traj_x[:, 0, 1], color="tab:blue", lw=1.5,
            label="ego (lattice)")
    k = out["overtake_step"]
    if k is not None and not out["collided"]:
        ax.plot(traj_x[k, 0, 0], traj_x[k, 0, 1], "g*", ms=16,
                label=f"overtake t={k * 0.1:.1f}s")
    ax.set_aspect("equal")
    ax.legend(loc="upper right")
    mode = "lidar-perceived" if args.from_scan else "privileged-pose"
    ax.set_title(f"lattice-planner overtake, {mode} opponent "
                 "(SAT rectangle collision)")
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    fig.savefig(path, dpi=110, bbox_inches="tight")
    plt.close(fig)
    print(f"saved {path}")


def main(argv=None) -> dict:
    args = parse_args(argv)
    out = run(args)
    draw(out, args, args.out)
    return out


if __name__ == "__main__":
    main()
