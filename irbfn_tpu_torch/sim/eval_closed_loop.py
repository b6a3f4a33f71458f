"""Closed-loop robustness sweep: run a planner in the batched simulator over
a (mu, cs) grid x noisy-start trials, collect lateral/heading deviation,
completion rate and laps.

Port of ``scripts/eval_closed_loop.py``, every planner and flag:
``irbfn`` (the learned Frenet planner), ``irbfn_adaptive`` (the
grip-adaptive bank: ``--bank CONFIG:CKPT ...`` with ``--arm_mus``, the grip
observer choosing each lane's arm and pace), ``irbfn_cart`` (the cartesian
learned planner), ``nmpc`` (the batched solver in the loop), ``explicit``
(table lookup with the exact-reflection mirror and a hard brake on an
infeasible cell), ``goal_mpc``, ``goal_mpc_net`` and ``pursuit``. All (mu,
cs, trial) episodes run as ONE batch on the device; failed trials
(off-track or a crash before the horizon ends) are retried with fresh start
noise, drawn as the JAX script draws it: ``key, sub = split(key)`` from
``PRNGKey(--seed)`` for each attempt (``utils/prng.py``). The world is the synthetic oval with a corridor, or a reference-format
track bundle (``--map_dir``: collision against the occupancy map instead,
``--line``/``--line_csv`` for the line followed).

Usage: ``python -m irbfn_tpu_torch.sim.eval_closed_loop --planner irbfn
--config_f RUN.json --ckpt RUN_DIR [--map_dir BUNDLE] [--n_steps 600]
[--device cuda]``
"""

from __future__ import annotations

import argparse
import pickle

import numpy as np
import torch

from irbfn_tpu_torch._device import resolve_device
from irbfn_tpu_torch.dynamics.params import (VehicleParams, f1tenth_params,
                                             fullscale_params)
from irbfn_tpu_torch.sim.env import TrackEnv, deviation_metrics
from irbfn_tpu_torch.sim.track import (horizon_goal_speed, interp_wrapped,
                                       oval_track)
from irbfn_tpu_torch.utils import prng
from irbfn_tpu_torch.utils.args import add_eval_args

PLANNERS = ("irbfn", "irbfn_adaptive", "irbfn_cart", "nmpc", "explicit",
            "pursuit", "goal_mpc", "goal_mpc_net")


def explicit_policy(table, track, horizon_time: float):
    """Table lookup in the loop: multilinear lookup of the mirrored state,
    the steer rate un-mirrored. An infeasible cell brakes hard: the cell
    being infeasible means "this state cannot track at this speed", and
    braking re-enters the feasible set (coasting sails straight off)."""
    from irbfn_tpu_torch.planning.explicit import grid_lookup_linear
    from irbfn_tpu_torch.planning.planner import frenet_query

    rl = track.raceline

    def policy(obs):
        curv = interp_wrapped(rl.ss, rl.ks, obs.s, rl.length)
        # horizon-end goal speed: braking starts BEFORE the corner
        vx_goal = horizon_goal_speed(rl, obs.s, obs.linear_vel_x,
                                     horizon_time)
        q, sign = frenet_query(obs.ey, obs.delta, obs.linear_vel_x,
                               obs.linear_vel_y, vx_goal, obs.ang_vel_z,
                               obs.epsi, curv)
        out, valid = grid_lookup_linear(table, q)
        T = out.shape[-1] // 2
        act = torch.stack([out[..., 0], sign * out[..., T]], dim=-1)
        brake = torch.stack([torch.full_like(obs.ey, -9.51),
                             torch.zeros_like(obs.ey)], dim=-1)
        return torch.where(valid[..., None], act.to(brake.dtype), brake)

    return policy


def make_policy(args, track, device):
    """The batched closed-loop policy ``obs -> action``, or for a stateful
    planner (``irbfn_adaptive``) the pair ``(policy(state, obs) -> (action,
    state), init_state(batch_shape))``."""
    rl = track.raceline
    if args.planner == "irbfn":
        if not args.config_f:
            raise SystemExit("--planner irbfn requires --config_f/--ckpt")
        from irbfn_tpu_torch.planning import IRBFNFrenetPlanner
        from irbfn_tpu_torch.train import (input_bounds_from_config,
                                           load_model)

        model, conf = load_model(args.config_f, args.ckpt, device=device)
        planner = IRBFNFrenetPlanner(
            model.eval(), track, input_bounds=input_bounds_from_config(conf))

        def policy(obs):
            res = planner.plan_batch(obs.s, obs.ey, obs.epsi, obs.delta,
                                     obs.linear_vel_x, obs.linear_vel_y,
                                     obs.ang_vel_z)
            return torch.stack([res.accel, res.steer_vel], dim=-1)
    elif args.planner == "irbfn_adaptive":
        # the grip observer picks each lane's nearest-mu arm AND its sqrt(g)
        # pace online (planning/grip.py, GripAdaptiveFrenetPlanner)
        if not args.bank:
            raise SystemExit("--planner irbfn_adaptive requires --bank "
                             "CONFIG:CKPT pairs + --arm_mus")
        if not args.arm_mus or len(args.arm_mus) != len(args.bank):
            raise SystemExit("--arm_mus must pair with --bank")
        from irbfn_tpu_torch.planning import GripAdaptiveFrenetPlanner
        from irbfn_tpu_torch.planning.grip import GripConfig
        from irbfn_tpu_torch.train import (input_bounds_from_config,
                                           load_model)

        order = np.argsort(args.arm_mus)
        models, conf0 = [], None
        for i in order:
            cf, ck = args.bank[i].rsplit(":", 1)
            model, conf = load_model(cf, ck, device=device)
            models.append(model.eval())
            conf0 = conf if conf0 is None else conf0
        planner = GripAdaptiveFrenetPlanner(
            models[0], models, np.asarray(args.arm_mus)[order], track,
            input_bounds=input_bounds_from_config(conf0),
            grip_cfg=GripConfig(g0=args.g0), pace_lo=args.pace_lo,
            pace_hi=args.pace_hi, pace_margin=args.pace_margin)
        return planner.policy(), planner.init_state
    elif args.planner == "irbfn_cart":
        # body-frame lookahead goal, exact mirror, steer-angle setpoint
        if not args.config_f:
            raise SystemExit("--planner irbfn_cart requires --config_f/--ckpt")
        from irbfn_tpu_torch.planning import IRBFNPlanner
        from irbfn_tpu_torch.train import (input_bounds_from_config,
                                           load_model)

        model, conf = load_model(args.config_f, args.ckpt, device=device)
        planner = IRBFNPlanner(model.eval(), track,
                               mirror=bool(conf.get("mirror", True)),
                               sv_ind=int(conf["out_features"]) // 2,
                               input_bounds=input_bounds_from_config(conf))

        def policy(obs):
            res = planner.plan_batch(obs.pose_x, obs.pose_y, obs.pose_theta,
                                     obs.delta, obs.linear_vel_x, obs.beta,
                                     obs.ang_vel_z)
            return torch.stack([res.accel, res.steer_vel], dim=-1)
    elif args.planner == "explicit":
        if not args.table_path:
            raise SystemExit("--planner explicit requires --table_path")
        from irbfn_tpu_torch.planning.explicit import grid_table_from_arrays

        d = np.load(args.table_path)
        table = grid_table_from_arrays(
            d["inputs"], d["outputs"],
            d["valid"] if "valid" in d.files else None, device=device)
        policy = explicit_policy(table, track, args.horizon * args.ctrl_dt)
    elif args.planner in ("goal_mpc", "goal_mpc_net"):
        from irbfn_tpu_torch.planning import GoalMPCPlanner
        from irbfn_tpu_torch.train import load_model

        net = None
        if args.planner == "goal_mpc_net":
            if not args.config_f:
                raise SystemExit("goal_mpc_net requires --config_f/--ckpt")
            net = load_model(args.config_f, args.ckpt,
                             device=device)[0].eval()
        planner = GoalMPCPlanner(track, net)

        def policy(obs):
            return torch.stack(planner.plan_batch(
                obs.pose_x, obs.pose_y, obs.pose_theta, obs.linear_vel_x),
                dim=-1)
    elif args.planner == "nmpc":
        # nominal internal model: the sim's (mu, cs) vary, the planner's
        # don't; that mismatch IS the robustness experiment
        from irbfn_tpu_torch.solvers import NMPCConfig, solve_nmpc_batch

        solver_params = fullscale_params(device=device)
        cfg = NMPCConfig(gn_iters=args.gn_iters, al_outer=args.al_outer)
        ht = cfg.horizon * cfg.dt

        def policy(obs):
            zeros = torch.zeros_like(obs.ey)
            x0 = torch.stack([zeros, obs.ey, obs.delta, obs.linear_vel_x,
                              obs.linear_vel_y, obs.ang_vel_z, obs.epsi],
                             dim=-1)
            curv = interp_wrapped(rl.ss, rl.ks, obs.s, rl.length)
            vx_goal = horizon_goal_speed(rl, obs.s, obs.linear_vel_x, ht)
            goal = torch.stack([zeros] * 3 + [vx_goal] + [zeros] * 3, dim=-1)
            sol = solve_nmpc_batch(x0, goal, curv, solver_params, cfg)
            return torch.stack([sol.accel[..., 0], sol.steer_vel[..., 0]],
                               dim=-1)
    else:  # pursuit: geometric P-control baseline
        def policy(obs):
            sv = torch.clamp(-1.0 * obs.ey - 1.5 * obs.epsi
                             - 0.8 * obs.delta, -3.2, 3.2)
            a = torch.clamp(2.0 * (3.0 - obs.linear_vel_x), -9.51, 9.51)
            return torch.stack([a, sv], dim=-1)
    return policy


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    add_eval_args(p)
    p.add_argument("--config_f", type=str, default=None)
    p.add_argument("--ckpt", type=str, default=None)
    p.add_argument("--planner", choices=PLANNERS, default="nmpc")
    p.add_argument("--bank", type=str, nargs="+", default=None,
                   help="per-arm CONFIG:CKPT pairs for --planner "
                        "irbfn_adaptive (one net per trained mu)")
    p.add_argument("--arm_mus", type=float, nargs="+", default=None,
                   help="training mu of each --bank arm")
    p.add_argument("--g0", type=float, default=0.5,
                   help="grip observer prior (initial pace = sqrt(g0))")
    p.add_argument("--pace_lo", type=float, default=0.35)
    p.add_argument("--pace_hi", type=float, default=1.0)
    p.add_argument("--pace_margin", type=float, default=1.0)
    p.add_argument("--table_path", type=str, default=None,
                   help="solver-table npz for --planner explicit")
    p.add_argument("--horizon", type=int, default=5,
                   help="table generator's control horizon (goal-speed "
                        "lookahead = horizon * ctrl_dt)")
    p.add_argument("--ctrl_dt", type=float, default=0.1,
                   help="table generator's control dt")
    p.add_argument("--speed_scale", type=float, default=1.0,
                   help="scale the raceline speed profile")
    p.add_argument("--oval_scale", type=float, default=1.0,
                   help="scale the synthetic oval's size (no --map_dir); "
                        "curvature scales as 1/oval_scale")
    p.add_argument("--half_width", type=float, default=2.0,
                   help="corridor half width; leaving it fails the trial")
    p.add_argument("--max_retries", type=int, default=2,
                   help="noisy-start retries for failed trials")
    p.add_argument("--gn_iters", type=int, default=25)
    p.add_argument("--al_outer", type=int, default=3)
    p.add_argument("--map_dir", type=str, default=None,
                   help="reference-format track dir; collision then checks "
                        "the occupancy map instead of a corridor")
    p.add_argument("--line", choices=["raceline", "centerline"],
                   default="raceline",
                   help="which line of the bundle to follow (centerline = "
                        "mid-track, unit speed profile: combine with "
                        "--speed_scale)")
    p.add_argument("--line_csv", type=str, default=None,
                   help="a line CSV overriding the bundle's raceline/"
                        "centerline (needs --map_dir)")
    p.add_argument("--car_radius", type=float, default=0.15,
                   help="collision disc radius against the occupancy map")
    p.add_argument("--save_tube", type=str, default=None,
                   help="save the visited 8-dim net-input states (the "
                        "closed-loop operating tube) to this npz; feeds "
                        "train_frenet --tube_npz")
    p.add_argument("--device", type=str, default=None,
                   help="where the sweep runs (default: the card)")
    return p.parse_args(argv)


def sweep_params(combos: np.ndarray, num_trials: int, device) -> VehicleParams:
    """Per-lane vehicles: each episode gets its own (mu, cs)."""
    mu = torch.as_tensor(np.repeat(combos[:, 0], num_trials),
                         dtype=torch.float32, device=device)
    cs = torch.as_tensor(np.repeat(combos[:, 1], num_trials),
                         dtype=torch.float32, device=device)
    B = mu.numel()
    base = f1tenth_params(device=device)
    lane = {f: getattr(base, f).expand(B).contiguous()
            for f in ("m", "I", "lf", "lr", "h", "sv_max", "a_max", "s_max",
                      "v_max")}
    return VehicleParams(mu=mu, C_Sf=cs, C_Sr=cs,
                         dt=torch.full((B,), 0.01, device=device), **lane)


def make_world(args, device):
    """``(track, occ_map)``: a track bundle's line and map (``--map_dir``,
    with ``--line`` or ``--line_csv``), or the oval and no map."""
    if args.map_dir:
        from irbfn_tpu_torch.sim.map import (load_track_bundle,
                                             raceline_from_csv)
        from irbfn_tpu_torch.sim.track import Track

        track, omap = load_track_bundle(args.map_dir, prefer=args.line,
                                        device=device)
        if args.line_csv:
            track = Track(raceline_from_csv(args.line_csv, device=device))
    elif args.line_csv:
        raise SystemExit("--line_csv needs --map_dir (the map it runs in)")
    else:
        omap = None
        track = oval_track(30.0 * args.oval_scale, 15.0 * args.oval_scale,
                           n_samples=512, speed=3.0, device=device)
    if args.speed_scale != 1.0:
        rl0 = track.raceline
        track = track._replace(raceline=rl0._replace(
            vxs=rl0.vxs * args.speed_scale))
    return track, omap


def run(args, on_attempt=None) -> dict:
    """The sweep; returns the result dict that ``main`` pickles.
    ``on_attempt(attempt, final, traj, policy_state)``, if given, sees every
    attempt's rollout."""
    device = resolve_device(args.device)
    mus = np.linspace(args.mu_min, args.mu_max, args.num_mu)
    css = np.linspace(args.cs_min, args.cs_max, args.num_cs)
    mu_g, cs_g = np.meshgrid(mus, css, indexing="ij")
    combos = np.stack([mu_g.reshape(-1), cs_g.reshape(-1)], axis=-1)
    n_combo = combos.shape[0]
    B = n_combo * args.num_trials

    track, omap = make_world(args, device)
    env = TrackEnv(track, sweep_params(combos, args.num_trials, device),
                   half_width=None if omap is not None else args.half_width,
                   occ_map=omap, car_radius=args.car_radius,
                   control_mode=("speed" if args.planner.startswith(
                       "goal_mpc") else "accl"))
    policy = make_policy(args, track, device)
    init_state = None
    if isinstance(policy, tuple):  # stateful planner (grip observer carry)
        policy, init_state = policy
    key = prng.PRNGKey(args.seed)

    # trial loop with noisy-start retries: rerun the batched rollout,
    # keeping each episode's first successful attempt
    ey_res = np.full(B, np.nan)
    epsi_res = np.full(B, np.nan)
    laps_res = np.zeros(B)
    vx_res = np.full(B, np.nan)
    g_res = np.full(B, np.nan)
    success = np.zeros(B, bool)
    tube_chunks = []
    rl = track.raceline
    for attempt in range(args.max_retries + 1):
        key, sub = prng.split(key)
        sim0 = env.reset(s0=0.0, speed0=1.0, key=sub,
                         noise_scale=args.noise_scale, batch_shape=(B,))
        if init_state is not None:
            final, pstate, traj = env.rollout_stateful(
                sim0, policy, init_state((B,)), n_steps=args.n_steps)
        else:
            pstate = None
            final, traj = env.rollout(sim0, policy, n_steps=args.n_steps)
        if on_attempt is not None:
            on_attempt(attempt, final, traj, pstate)
        alive = ~traj.done.cpu().numpy()
        if args.save_tube:
            o = traj.obs
            curv_t = interp_wrapped(rl.ss, rl.ks, o.s, rl.length)
            vxg_t = horizon_goal_speed(rl, o.s, o.linear_vel_x,
                                       args.horizon * args.ctrl_dt)
            states = torch.stack(
                [o.ey, o.delta, o.linear_vel_x, o.linear_vel_y, vxg_t,
                 o.ang_vel_z, o.epsi, curv_t], dim=-1).cpu().numpy()
            tube_chunks.append(states[alive])
        ey_mean, epsi_mean = deviation_metrics(traj)
        # pace honesty metric: mean driven speed over alive steps
        vx_t = traj.obs.linear_vel_x.cpu().numpy()
        vx_mean = (vx_t * alive).sum(0) / np.maximum(alive.sum(0), 1)
        ok = ~final.done.cpu().numpy()
        newly = (ok | (attempt == args.max_retries)) & ~success
        ey_res[newly] = ey_mean.cpu().numpy()[newly]
        epsi_res[newly] = epsi_mean.cpu().numpy()[newly]
        laps_res[newly] = final.laps.cpu().numpy()[newly]
        vx_res[newly] = vx_mean[newly]
        if pstate is not None:
            g_res[newly] = pstate.g.cpu().numpy()[newly]
        success |= ok
        if success.all():
            break
        print(f"attempt {attempt + 1}: {int((~success).sum())}/{B} trials "
              "failed (off-track/crash), retrying with fresh noise",
              flush=True)

    def by_combo(a):
        return a.reshape(n_combo, args.num_trials).mean(1)

    res = {"combos": combos, "ey": by_combo(ey_res),
           "epsi": by_combo(epsi_res),
           "completion": by_combo(success.astype(float)),
           "laps": by_combo(laps_res), "vx_mean": by_combo(vx_res),
           "g_est": by_combo(g_res), "planner": args.planner}
    for i, (mu, cs) in enumerate(combos):
        g = res["g_est"][i]
        extra = f" g_est={g:.2f}" if np.isfinite(g) else ""
        print(f"mu={mu:.2f} cs={cs:.2f}: mean|ey|={res['ey'][i]:.4f} "
              f"mean|epsi|={res['epsi'][i]:.4f} "
              f"completion={res['completion'][i]:.2f} "
              f"laps={res['laps'][i]:.1f} vx={res['vx_mean'][i]:.2f}{extra}")
    if args.save_tube and tube_chunks:
        tube = np.concatenate(tube_chunks, axis=0)
        np.savez_compressed(args.save_tube, states=tube)
        print(f"saved {tube.shape[0]} tube states to {args.save_tube}")
    return res


def main(argv=None) -> dict:
    args = parse_args(argv)
    res = run(args)
    with open(f"{args.out_name}.pkl", "wb") as f:
        pickle.dump(res, f)
    print(f"saved {args.out_name}.pkl")
    return res


if __name__ == "__main__":
    main()
