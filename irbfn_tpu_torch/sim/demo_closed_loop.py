"""Closed-loop demo: drive one car with a planner around the track, print
lap metrics, save an episode figure (or a GIF).

Port of ``scripts/demo_closed_loop.py``, with its flags, plus ``--device``.
Planners: ``nmpc`` (the solver in the loop), ``irbfn`` (the learned Frenet
planner), ``irbfn_cart`` (the cartesian net), ``pursuit`` (geometric
baseline), ``goal_mpc`` (the goal MPC solved every step: one
``admm_solve`` launch) and ``goal_mpc_net`` (its trained net). The nets are
read from a config JSON and a weights npz (``--config_f``, ``--ckpt``), as
``irbfn_tpu_torch/assets/`` holds them; on the card each planning step is
one ``rbf_forward`` kernel launch.

``run(args)`` drives the episode; the figure is drawn after it (matplotlib,
Pillow for a GIF).

Usage: ``python -m irbfn_tpu_torch.sim.demo_closed_loop --planner irbfn
--config_f irbfn_tpu_torch/assets/frenet_wide_pr1.json --ckpt
irbfn_tpu_torch/assets/frenet_wide_pr1.npz [--n_steps 400] [--out
torch_runs/demo_episode.png] [--device cpu]``
"""

from __future__ import annotations

import argparse
import os

import torch

from irbfn_tpu_torch._device import resolve_device, wait_clock
from irbfn_tpu_torch.dynamics.params import f1tenth_params, fullscale_params
from irbfn_tpu_torch.sim.env import TrackEnv, deviation_metrics
from irbfn_tpu_torch.sim.track import interp_wrapped, oval_track

PLANNERS = ("nmpc", "irbfn", "irbfn_cart", "pursuit", "goal_mpc",
            "goal_mpc_net")


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--planner", choices=PLANNERS, default="nmpc")
    p.add_argument("--config_f", type=str, default=None)
    p.add_argument("--ckpt", type=str, default=None)
    p.add_argument("--n_steps", type=int, default=400)
    p.add_argument("--speed", type=float, default=3.0)
    p.add_argument("--out", type=str, default="torch_runs/demo_episode.png")
    p.add_argument("--map_dir", type=str, default=None,
                   help="reference-format track dir (<name>_map.yaml + "
                        "raceline csv); collision then uses the real map")
    p.add_argument("--speed_scale", type=float, default=1.0,
                   help="scale the raceline speed profile (map tracks)")
    p.add_argument("--car_radius", type=float, default=0.15,
                   help="collision disc radius on map tracks (reference "
                        "racelines pinch below car-radius clearance in "
                        "places)")
    p.add_argument("--goal_lookahead", type=float, default=None,
                   help="goal-MPC lookahead horizon [s] (default T*dt=0.4)")
    p.add_argument("--control_dt", type=float, default=0.1,
                   help="replanning period [s]. The cartesian net has no "
                        "delta input (every plan assumes steering starts at "
                        "0), so it is stable only when replanned fast "
                        "enough that delta stays near 0 between plans")
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: the card)")
    return p.parse_args(argv)


def _net(args, device):
    from irbfn_tpu_torch.train import load_model

    if not args.config_f:
        raise SystemExit(f"--planner {args.planner} requires "
                         "--config_f/--ckpt")
    model, conf = load_model(args.config_f, args.ckpt, device=device)
    return model.eval(), conf


def make_episode(args, device):
    """``(track, env, sim, policy)`` for the flags: the world, one car at
    s = 0, and the planner as ``obs -> action``."""
    params = f1tenth_params(dtype=torch.float32, device=device)
    if args.map_dir:
        from irbfn_tpu_torch.sim.map import load_track_bundle

        track, omap = load_track_bundle(args.map_dir, device=device)
        if args.speed_scale != 1.0:
            rl0 = track.raceline
            track = track._replace(raceline=rl0._replace(
                vxs=rl0.vxs * args.speed_scale))
        env_kw = dict(occ_map=omap, car_radius=args.car_radius)
    else:
        track = oval_track(n_samples=512, speed=args.speed, device=device)
        env_kw = {}
    env = TrackEnv(track, params, control_dt=args.control_dt, **env_kw)
    rl = track.raceline

    if args.planner == "irbfn":
        from irbfn_tpu_torch.planning import IRBFNFrenetPlanner
        from irbfn_tpu_torch.train import input_bounds_from_config

        model, conf = _net(args, device)
        planner = IRBFNFrenetPlanner(
            model, track, input_bounds=input_bounds_from_config(conf))

        def policy(obs):
            res = planner.plan_batch(obs.s, obs.ey, obs.epsi, obs.delta,
                                     obs.linear_vel_x, obs.linear_vel_y,
                                     obs.ang_vel_z)
            return torch.stack([res.accel, res.steer_vel], dim=-1)
    elif args.planner == "irbfn_cart":
        from irbfn_tpu_torch.planning import IRBFNPlanner
        from irbfn_tpu_torch.train import input_bounds_from_config

        model, conf = _net(args, device)
        planner = IRBFNPlanner(model, track,
                               mirror=bool(conf.get("mirror", True)),
                               sv_ind=int(conf["out_features"]) // 2,
                               input_bounds=input_bounds_from_config(conf))

        def policy(obs):
            res = planner.plan_batch(obs.pose_x, obs.pose_y, obs.pose_theta,
                                     obs.delta, obs.linear_vel_x, obs.beta,
                                     obs.ang_vel_z)
            return torch.stack([res.accel, res.steer_vel], dim=-1)
    elif args.planner in ("goal_mpc", "goal_mpc_net"):
        # (speed, steer) actions through the speed control mode; "goal_mpc"
        # solves the QP every step, "_net" serves its trained compression
        from irbfn_tpu_torch.planning import GoalMPCPlanner

        net = _net(args, device)[0] if args.planner == "goal_mpc_net" else None
        planner = GoalMPCPlanner(track, net,
                                 horizon_time=args.goal_lookahead)
        env = TrackEnv(track, params, control_dt=args.control_dt,
                       control_mode="speed", **env_kw)

        def policy(obs):
            return torch.stack(planner.plan_batch(
                obs.pose_x, obs.pose_y, obs.pose_theta, obs.linear_vel_x),
                dim=-1)
    elif args.planner == "nmpc":
        from irbfn_tpu_torch.solvers import NMPCConfig, solve_nmpc_batch

        solver_params = fullscale_params(dtype=torch.float32, device=device)
        cfg = NMPCConfig(gn_iters=25, al_outer=3)

        def policy(obs):
            zeros = torch.zeros_like(obs.ey)
            x0 = torch.stack([zeros, obs.ey, obs.delta, obs.linear_vel_x,
                              obs.linear_vel_y, obs.ang_vel_z, obs.epsi],
                             dim=-1)
            curv = interp_wrapped(rl.ss, rl.ks, obs.s, rl.length)
            vx_goal = interp_wrapped(rl.ss, rl.vxs, obs.s, rl.length)
            goal = torch.stack([zeros] * 3 + [vx_goal] + [zeros] * 3, dim=-1)
            sol = solve_nmpc_batch(x0, goal, curv, solver_params, cfg)
            return torch.stack([sol.accel[..., 0], sol.steer_vel[..., 0]],
                               dim=-1)
    else:
        def policy(obs):
            sv = torch.clamp(-1.0 * obs.ey - 1.5 * obs.epsi
                             - 0.8 * obs.delta, -3.2, 3.2)
            a = torch.clamp(2.0 * (args.speed - obs.linear_vel_x),
                            -9.51, 9.51)
            return torch.stack([a, sv], dim=-1)
    sim = env.reset(s0=0.0, speed0=1.0, batch_shape=(1,))
    return track, env, sim, policy


def run(args) -> dict:
    """Drive the episode and print its metrics; returns them with the
    trajectory."""
    device = resolve_device(args.device)
    track, env, sim, policy = make_episode(args, device)
    t0 = wait_clock(device)
    final, traj = env.rollout(sim, policy, n_steps=args.n_steps)
    wall = wait_clock(device) - t0
    ey_mean, epsi_mean = deviation_metrics(traj)
    sim_time = args.n_steps * args.control_dt
    print(f"{args.planner}: {args.n_steps} control steps "
          f"({sim_time:.0f}s sim) in {wall:.2f}s wall "
          f"({sim_time / wall:.1f}x realtime)")
    crashed = bool(final.done[0])
    print(f"laps {int(final.laps[0])}  progress {float(final.s[0]):.1f} m  "
          f"mean|ey| {float(ey_mean[0]):.3f} m  "
          f"mean|epsi| {float(epsi_mean[0]):.3f} rad  "
          f"[{'CRASHED' if crashed else 'ok'}]")
    return dict(track=track, env=env, final=final, traj=traj, wall=wall,
                laps=int(final.laps[0]), progress=float(final.s[0]),
                ey=float(ey_mean[0]), epsi=float(epsi_mean[0]),
                crashed=crashed)


def draw(out: dict, path: str):
    """The episode as a PNG, or as a GIF when ``path`` ends in .gif."""
    from irbfn_tpu_torch.sim.render import animate_episode, plot_episode

    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    if path.endswith(".gif"):
        animate_episode(out["track"], out["traj"], path=path, stride=2,
                        occ_map=out["env"].occ_map)
    else:
        plot_episode(out["track"], out["traj"], path=path)
    print(f"saved {path}")


def main(argv=None) -> dict:
    args = parse_args(argv)
    out = run(args)
    draw(out, args.out)
    return out


if __name__ == "__main__":
    main()
