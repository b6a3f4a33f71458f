"""Closed-loop EXP3 adaptation over a multi-mu bank of explicit tables or
learned nets, on a reference-format track bundle.

Port of ``scripts/eval_adaptive.py``. Per (mu, cs) sim combo an EXP3 bandit
picks which arm drives each episode; the episode's reward is its lap
progress. All combos run as ONE batch per episode round: the table bank is
one multilinear lookup with the arm as an extra exact-integer grid dimension
(``planning/explicit.py:stack_grid_tables``), the net bank one forward per
arm and a gather by arm (``planning/planner.py:stack_net_bank``). Every fixed
arm is also run over every combo, for the adaptive-vs-fixed table. Start
noise and arms are the JAX script's draws for ``--seed``: one key split per
round from ``PRNGKey(seed)``, and bandit i seeded ``seed + i``
(``utils/prng.py``).

Usage: ``python -m irbfn_tpu_torch.sim.eval_adaptive --map_dir BUNDLE
--arm_mus 0.6 0.8 1.0 (--tables T1.npz T2.npz T3.npz | --nets C1:K1 ...)
[--device cuda]``
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from irbfn_tpu_torch._device import resolve_device
from irbfn_tpu_torch.dynamics.params import VehicleParams, f1tenth_params
from irbfn_tpu_torch.planning.bandits import EXP3
from irbfn_tpu_torch.planning.explicit import (grid_lookup_linear,
                                               grid_table_from_arrays,
                                               stack_grid_tables)
from irbfn_tpu_torch.planning.planner import frenet_query
from irbfn_tpu_torch.sim.env import TrackEnv
from irbfn_tpu_torch.sim.map import load_track_bundle
from irbfn_tpu_torch.sim.track import horizon_goal_speed, interp_wrapped
from irbfn_tpu_torch.utils import prng


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--tables", type=str, nargs="+", default=None,
                   help="one solver-table npz per arm (same lattice); not "
                        "needed with --nets")
    p.add_argument("--arm_mus", type=float, nargs="+", required=True)
    p.add_argument("--map_dir", type=str, required=True)
    p.add_argument("--mus", type=float, nargs="+", default=[0.6, 0.8, 1.0])
    p.add_argument("--css", type=float, nargs="+", default=[5.0])
    p.add_argument("--episodes", type=int, default=20)
    p.add_argument("--n_steps", type=int, default=600)
    p.add_argument("--gamma", type=float, default=0.3)
    p.add_argument("--prog_norm", type=float, default=1.0,
                   help="laps of progress that count as reward 1.0; >1 "
                        "makes the reward pace-aware")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--noise_scale", type=float, default=0.01)
    p.add_argument("--horizon_time", type=float, default=0.5)
    p.add_argument("--speed_scales", type=float, nargs="+", default=None,
                   help="per-arm raceline speed multiplier; default "
                        "sqrt(arm_mu / max(arm_mus)), the grip-limited "
                        "cornering speed of each arm's mu")
    p.add_argument("--baseline_rounds", type=int, default=3,
                   help="rounds to average each fixed-arm baseline over")
    p.add_argument("--nets", type=str, nargs="+", default=None,
                   help="per-arm CONFIG:CKPT pairs: run the learned planner "
                        "bank instead of table lookups (all arms of one "
                        "architecture)")
    p.add_argument("--json_out", type=str, default="adaptive_results.json")
    p.add_argument("--device", type=str, default=None,
                   help="where the rounds run (default: the card)")
    return p.parse_args(argv)


def sweep_params(combos, device) -> VehicleParams:
    """One vehicle per (mu, cs) combo."""
    B = len(combos)
    base = f1tenth_params(device=device)
    lane = {f: getattr(base, f).expand(B).contiguous()
            for f in ("m", "I", "lf", "lr", "h", "sv_max", "a_max", "s_max",
                      "v_max")}
    t = lambda v: torch.tensor(v, dtype=torch.float32,  # noqa: E731
                               device=device)
    return VehicleParams(mu=t([c[0] for c in combos]),
                         C_Sf=t([c[1] for c in combos]),
                         C_Sr=t([c[1] for c in combos]),
                         dt=torch.full((B,), 0.01, device=device), **lane)


def run(args) -> dict:
    """The experiment; returns the results that ``main`` writes as JSON."""
    if not args.tables and not args.nets:
        raise SystemExit("need --tables (table bank) or --nets (learned bank)")
    device = resolve_device(args.device)
    n_arms = len(args.arm_mus)
    stacked = None
    if args.tables:
        if len(args.tables) != n_arms:
            raise SystemExit("one --tables npz per --arm_mus entry")
        tables = []
        for path in args.tables:
            d = np.load(path)
            tables.append(grid_table_from_arrays(
                d["inputs"], d["outputs"],
                d["valid"] if "valid" in d.files else None, device=device))
        stacked = stack_grid_tables(tables)

    net_apply, net_bounds = None, None
    if args.nets:
        if len(args.nets) != n_arms:
            raise SystemExit("one --nets CONFIG:CKPT per --arm_mus entry")
        from irbfn_tpu_torch.planning import stack_net_bank
        from irbfn_tpu_torch.train import (input_bounds_from_config,
                                           load_model)

        models, conf0 = [], None
        for spec in args.nets:
            cf, ck = spec.rsplit(":", 1)
            model, conf = load_model(cf, ck, device=device)
            models.append(model.eval())
            conf0 = conf if conf0 is None else conf0
        net_bounds = torch.as_tensor(input_bounds_from_config(conf0),
                                     dtype=torch.float32, device=device)
        net_apply, bank = stack_net_bank(models[0], models)
    if args.speed_scales is None:
        mu_ref = max(args.arm_mus)
        args.speed_scales = [float(np.sqrt(m / mu_ref)) for m in args.arm_mus]
    if len(args.speed_scales) != n_arms:
        raise SystemExit("one --speed_scales entry per arm")
    scales = torch.tensor(args.speed_scales, dtype=torch.float32,
                          device=device)
    print("per-arm speed scales:", [f"{s:.3f}" for s in args.speed_scales])

    track, omap = load_track_bundle(args.map_dir, device=device)
    rl = track.raceline
    combos = [(mu, cs) for mu in args.mus for cs in args.css]
    B = len(combos)
    env = TrackEnv(track, sweep_params(combos, device), occ_map=omap,
                   car_radius=0.15)

    def make_policy(arm_b):
        arm_i = arm_b.to(torch.int64)

        def policy(obs):
            curv = interp_wrapped(rl.ss, rl.ks, obs.s, rl.length)
            vx_goal = horizon_goal_speed(rl, obs.s, obs.linear_vel_x,
                                         args.horizon_time) * scales[arm_i]
            q, sign = frenet_query(obs.ey, obs.delta, obs.linear_vel_x,
                                   obs.linear_vel_y, vx_goal, obs.ang_vel_z,
                                   obs.epsi, curv)
            if net_apply is not None:
                qn = torch.minimum(torch.maximum(q, net_bounds[:, 0]),
                                   net_bounds[:, 1])
                out_all = net_apply(bank, qn)  # (A, B, 2T)
                idx = arm_i[None, :, None].expand(1, B, out_all.shape[-1])
                out = torch.gather(out_all, 0, idx)[0]
                T = out.shape[-1] // 2
                return torch.stack([out[..., 0], sign * out[..., T]], dim=-1)
            qa = torch.cat([arm_b[..., None], q], dim=-1)
            out, valid = grid_lookup_linear(stacked, qa)
            T = out.shape[-1] // 2
            act = torch.stack([out[..., 0], sign * out[..., T]], dim=-1)
            brake = torch.stack([torch.full_like(obs.ey, -9.51),
                                 torch.zeros_like(obs.ey)], dim=-1)
            return torch.where(valid[..., None], act.to(brake.dtype), brake)

        return policy

    def run_round(arms, key):
        arm_b = torch.as_tensor(np.asarray(arms), dtype=torch.float32,
                                device=device)
        sim0 = env.reset(s0=0.0, speed0=1.0, key=key,
                         noise_scale=args.noise_scale, batch_shape=(B,))
        final, _ = env.rollout(sim0, make_policy(arm_b), args.n_steps)
        # reward: lap progress (a crash freezes s; a completed lap keeps
        # unwrapping, so prog_norm > 1 rewards pace, not just survival)
        prog = final.s.cpu().numpy() / float(rl.length)
        return np.clip(prog / args.prog_norm, 0.0, 1.0)

    # the JAX script's key chain: one split per round, baselines first
    key = prng.PRNGKey(args.seed)

    # fixed-arm baselines: every arm over every combo, averaged over rounds
    fixed = np.zeros((n_arms, B))
    for a in range(n_arms):
        for _ in range(args.baseline_rounds):
            key, sub = prng.split(key)
            fixed[a] += run_round(np.full(B, a), sub)
        fixed[a] /= args.baseline_rounds
        print(f"fixed arm mu={args.arm_mus[a]}: "
              + " ".join(f"{combos[i][0]:.1f}/{combos[i][1]:.0f}:"
                         f"{fixed[a, i]:.2f}" for i in range(B)), flush=True)

    bandits = [EXP3(n_arms, args.gamma, args.seed + i) for i in range(B)]
    pulls = np.zeros((args.episodes, B), int)
    rewards = np.zeros((args.episodes, B))
    for ep in range(args.episodes):
        arms = np.asarray([b.pull_arm() for b in bandits])
        key, sub = prng.split(key)
        r = run_round(arms, sub)
        for i, b in enumerate(bandits):
            # rewards are lap-progress fractions in [0, 1] already: the
            # reference's sigmoid squash would collapse the arms' gap
            b.update_dist(int(arms[i]), float(r[i]), rew_scale=None)
        pulls[ep], rewards[ep] = arms, r
        print(f"ep {ep:02d}: arms {arms.tolist()} rewards "
              + " ".join(f"{v:.2f}" for v in r), flush=True)

    results = {"combos": combos, "arm_mus": args.arm_mus,
               "mode": "learned" if args.nets else "table",
               "speed_scales": args.speed_scales,
               "baseline_rounds": args.baseline_rounds,
               "fixed_rewards": fixed.tolist(),
               "pulls": pulls.tolist(), "rewards": rewards.tolist()}
    half = args.episodes // 2
    print("\nper-combo summary (late-half episodes):")
    for i, (mu, cs) in enumerate(combos):
        late = pulls[half:, i]
        mode_arm = int(np.bincount(late, minlength=n_arms).argmax())
        best_fixed = int(fixed[:, i].argmax())
        adapt_r = float(rewards[half:, i].mean())
        print(f"  sim mu={mu:.1f} cs={cs:.0f}: bandit favors arm "
              f"mu={args.arm_mus[mode_arm]} ({(late == mode_arm).mean():.0%}"
              f" of late pulls); best fixed arm mu={args.arm_mus[best_fixed]}"
              f" (r={fixed[best_fixed, i]:.2f}); adaptive late reward "
              f"{adapt_r:.2f}")
        results.setdefault("summary", []).append(
            {"mu": mu, "cs": cs, "mode_arm_mu": args.arm_mus[mode_arm],
             "best_fixed_mu": args.arm_mus[best_fixed],
             "adaptive_late_reward": adapt_r,
             "best_fixed_reward": float(fixed[best_fixed, i])})
    return results


def main(argv=None) -> dict:
    args = parse_args(argv)
    results = run(args)
    with open(args.json_out, "w") as f:
        json.dump(results, f, indent=1)
    print(f"saved {args.json_out}")
    return results


if __name__ == "__main__":
    main()
