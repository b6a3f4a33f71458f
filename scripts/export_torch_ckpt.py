#!/usr/bin/env python
"""Export a committed JAX checkpoint for the PyTorch port, with goldens.

Needs JAX (it reads the YAML config and the orbax checkpoint through
``irbfn_tpu.train.load_model``) and the port (whose ``flatten_tree`` fixes
the npz layout). Writes to ``irbfn_tpu_torch/assets/``:

- ``<run>.npz``  — the flax parameter tree, keys like ``params/core/centers``
- ``<run>.json`` — the YAML config as JSON
- with ``--golden``, what ``chip_smoke.py`` holds the port against on the
  card. For a Frenet net, ``<run>_golden.npz``:
    * ``x``: 1024 net inputs drawn with numpy inside the config's
      ``input_bounds``, and ``forward_f64``: the flax forward on them in f64;
    * ``plan_in`` ([s, ey, epsi, delta, vx, vy, wz], a third of the rows
      with ey < -0.05 and some outside the trained grid, so both the mirror
      and the clamp are exercised) and ``plan_*``: the JAX
      ``IRBFNFrenetPlanner.plan_batch`` outputs on them, in f64;
    * ``loop_*``: the closed-loop sweep that ``chip_smoke.py`` runs (10x10
      (mu, cs) grid x 10 trials = 1000 lanes, 600 control steps on
      ``oval_track(30, 15, n_samples=512, speed=3.0)``, half width 2.0,
      start noise 0.01 * ``loop_noise``), run by the JAX package in f32:
      per-lane laps, done and mean |ey|.

  For the goal-MPC net (``goal_mpc_pr``), ``goal_mpc_golden.npz``:
    * ``lat_*``: 256 seeded rows of each of the 19 v_car families of the
      reference goal lattice (``lat_idx`` into the family's goal block,
      ``lat_goals`` in solver order (x, y, v, t)) and the JAX
      ``solve_goal_family`` results on them at 600 sweeps, in f32 and f64
      (speed, steer, controls, r_prim, r_dual, converged);
    * ``net_x`` and ``net_forward_f64``: 1024 net inputs inside the
      config's bounds and the flax forward on them in f64;
    * ``plan_pose`` (x, y, theta, v: 1024 seeded poses near the oval's
      raceline) and ``plan_{solver,net}_{speed,steer}_{f32,f64}``: the
      JAX ``GoalMPCPlanner.plan_batch`` outputs of both modes;
    * ``loop_{solver,net}_*``: the goal-MPC closed loops at the
      ``eval_closed_loop.py`` defaults (the sweep above, in the speed
      action mode), run by the JAX package in f32: per-lane laps, done,
      final progress and mean |ey|.

Usage (from the repo root):
    JAX_PLATFORMS=cpu python scripts/export_torch_ckpt.py --run frenet_wide_pr1 --golden
    JAX_PLATFORMS=cpu python scripts/export_torch_ckpt.py --run goal_mpc_pr --golden
"""

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, ".")

import jax  # noqa: E402

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402

from irbfn_tpu.dynamics.params import VehicleParams, f1tenth_params  # noqa: E402
from irbfn_tpu.parallel import GridSpec, build_lattice  # noqa: E402
from irbfn_tpu.planning import GoalMPCPlanner, IRBFNFrenetPlanner  # noqa: E402
from irbfn_tpu.solvers.goal_mpc import solve_goal_family  # noqa: E402
from irbfn_tpu.sim import TrackEnv, deviation_metrics, oval_track  # noqa: E402
from irbfn_tpu.train import input_bounds_from_config, load_model  # noqa: E402
from irbfn_tpu_torch.train import flatten_tree  # noqa: E402  (the npz format)

ASSETS = os.path.join("irbfn_tpu_torch", "assets")
N_GOLDEN = 1024
LOOP = dict(num_mu=10, mu_min=0.5, mu_max=1.1, num_cs=10, cs_min=1.0,
            cs_max=10.0, num_trials=10, n_steps=600, noise_scale=0.01,
            half_width=2.0, seed=123)


def sweep_lanes():
    """Per-lane (mu, cs) of the closed-loop sweep, as the eval script
    orders them: combos row-major over (mu, cs), trials repeated."""
    mus = np.linspace(LOOP["mu_min"], LOOP["mu_max"], LOOP["num_mu"])
    css = np.linspace(LOOP["cs_min"], LOOP["cs_max"], LOOP["num_cs"])
    mu_g, cs_g = np.meshgrid(mus, css, indexing="ij")
    n = LOOP["num_trials"]
    return np.repeat(mu_g.reshape(-1), n), np.repeat(cs_g.reshape(-1), n)


def draw_inputs(bounds, track_length, rng):
    """Net inputs inside the grid, and plan inputs partly outside it."""
    lo, hi = bounds[:, 0], bounds[:, 1]
    x = rng.uniform(lo, hi, size=(N_GOLDEN, lo.size)).astype(np.float32)
    # plan_batch inputs [s, ey, epsi, delta, vx, vy, wz]: state dims drawn
    # 10% past the grid on each side, so some rows are clamped
    idx = [0, 6, 1, 2, 3, 5]  # net-input dims of ey, epsi, delta, vx, vy, wz
    pad = 0.1 * (hi[idx] - lo[idx])
    st = rng.uniform(lo[idx] - pad, hi[idx] + pad, size=(N_GOLDEN, 6))
    third = np.arange(N_GOLDEN) % 3 == 0
    st[:, 0] = np.where(third, rng.uniform(-1.0, -0.05, N_GOLDEN),
                        rng.uniform(-0.05, 1.0, N_GOLDEN))
    s = rng.uniform(0.0, track_length, size=(N_GOLDEN, 1))
    return x, np.concatenate([s, st], axis=1).astype(np.float32)


def frenet_golden(model, variables, config):
    out = {}
    bounds = input_bounds_from_config(config)
    track = oval_track(30.0, 15.0, n_samples=512, speed=3.0)
    rng = np.random.default_rng(0)
    x, plan_in = draw_inputs(bounds, float(track.raceline.length), rng)
    params64 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), variables)
    out["x"] = x
    out["forward_f64"] = np.asarray(model.apply(params64,
                                                jnp.asarray(x, jnp.float64)))
    planner = IRBFNFrenetPlanner(model, params64, track, dtype=jnp.float64,
                                 use_pallas=False, input_bounds=bounds)
    res = planner.plan_batch(*plan_in.T.astype(np.float64))
    out["plan_in"] = plan_in
    for name, v in res._asdict().items():
        out[f"plan_{name}"] = np.asarray(v)

    # the closed-loop sweep, in f32 as the eval script runs it
    jax.config.update("jax_enable_x64", False)
    env, sim0, noise, mu, cs = sweep_env(track, "accl")
    params32 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), variables)
    planner32 = IRBFNFrenetPlanner(model, params32, track, use_pallas=False,
                                   input_bounds=bounds)

    def policy(obs):
        r = planner32.plan_batch(obs.s, obs.ey, obs.epsi, obs.delta,
                                 obs.linear_vel_x, obs.linear_vel_y,
                                 obs.ang_vel_z)
        return jnp.stack([r.accel, r.steer_vel], axis=-1)

    loop = run_sweep(env, sim0, policy)
    jax.config.update("jax_enable_x64", True)
    out.update(loop_noise=noise, loop_mu=mu.astype(np.float32),
               loop_cs=cs.astype(np.float32),
               **{f"loop_{k}": v for k, v in loop.items()})
    return out


def sweep_env(track, control_mode):
    """The closed-loop sweep's env and noisy start, in f32: (env, sim0,
    noise, mu, cs)."""
    mu, cs = sweep_lanes()
    B = mu.size
    base = f1tenth_params()
    full = lambda v: jnp.full((B,), v, jnp.float32)  # noqa: E731
    params_b = VehicleParams(
        mu=jnp.asarray(mu, jnp.float32), m=full(base.m), I=full(base.I),
        lf=full(base.lf), lr=full(base.lr), C_Sf=jnp.asarray(cs, jnp.float32),
        C_Sr=jnp.asarray(cs, jnp.float32), h=full(base.h), dt=full(0.01),
        sv_max=full(base.sv_max), a_max=full(base.a_max),
        s_max=full(base.s_max), v_max=full(base.v_max))
    env = TrackEnv(track, params_b, half_width=LOOP["half_width"],
                   control_mode=control_mode)
    noise = np.random.default_rng(LOOP["seed"]).standard_normal(
        (B, 3)).astype(np.float32)
    sim0 = env.reset(s0=jnp.zeros(B), speed0=1.0, batch_shape=(B,))
    # reset's pose noise, from numpy draws instead of a jax key
    dn = LOOP["noise_scale"] * jnp.asarray(noise)
    xs = sim0.x.at[:, 0].add(dn[:, 0]).at[:, 1].add(dn[:, 1])
    sim0 = sim0._replace(x=xs.at[:, 4].add(dn[:, 2]))
    return env, sim0, noise, mu, cs


def run_sweep(env, sim0, policy) -> dict:
    """Roll the sweep out; per-lane laps, done, final progress, mean |ey|."""
    B = sim0.s.shape[0]
    t0 = time.perf_counter()
    final, traj = env.rollout(sim0, policy, n_steps=LOOP["n_steps"])
    ey_mean, _ = deviation_metrics(traj)
    jax.block_until_ready(ey_mean)
    out = dict(laps=np.asarray(final.laps), done=np.asarray(final.done),
               s=np.asarray(final.s), ey_mean=np.asarray(ey_mean))
    print(f"closed loop: {B} lanes x {LOOP['n_steps']} steps in "
          f"{time.perf_counter() - t0:.1f} s (JAX, CPU); completed "
          f"{int((~out['done']).sum())}/{B}, laps>=1 "
          f"{int((out['laps'] >= 1).sum())}, mean|ey| over lanes "
          f"{float(np.nanmean(out['ey_mean'])):.4f}", flush=True)
    return out


# the reference goal lattice: scripts/gen_goal_mpc_table.py's default grid
GOAL_GRID = (GridSpec("v_car", -1.0, 8.0, 19),
             GridSpec("x_goal", -1.2, 4.0, 53),
             GridSpec("y_goal", 0.0, 4.0, 41),
             GridSpec("t_goal", -3.14, 3.14, 64),
             GridSpec("v_goal", -1.0, 8.0, 19))
N_LATTICE_ROWS = 256  # per family


def _solutions(sol, suffix) -> dict:
    return {f"{k}_{suffix}": np.asarray(v) for k, v in sol._asdict().items()}


def goal_golden(model, variables, config):
    out = {}
    rng = np.random.default_rng(0)
    # (a) seeded rows of every family of the reference lattice
    v_vals = GOAL_GRID[0].values()
    goals_raw = build_lattice(GOAL_GRID[1:], dtype=np.float32)  # x,y,t,v
    idx = np.stack([np.sort(rng.choice(goals_raw.shape[0], N_LATTICE_ROWS,
                                       replace=False)) for _ in v_vals])
    goals = goals_raw[idx][..., [0, 1, 3, 2]]  # solver order x,y,v,t
    out.update(lat_v=v_vals.astype(np.float32), lat_idx=idx, lat_goals=goals)
    for suffix, dt, x64 in (("f64", jnp.float64, True),
                            ("f32", jnp.float32, False)):
        with jax.enable_x64(x64):
            sols = [solve_goal_family(jnp.asarray(v, dt),
                                      jnp.asarray(g, dt), iters=600)
                    for v, g in zip(v_vals, goals)]
            sol = jax.tree.map(lambda *a: np.stack(a), *sols)
        out.update({f"lat_{k}": v for k, v in _solutions(sol, suffix).items()})
    print(f"lattice rows: {idx.size}, converged f64 "
          f"{out['lat_converged_f64'].mean():.4f} f32 "
          f"{out['lat_converged_f32'].mean():.4f}", flush=True)

    # net inputs inside the trained bounds, and the f64 forward
    bounds = input_bounds_from_config(config)
    out["net_x"] = rng.uniform(bounds[:, 0], bounds[:, 1],
                               (N_GOLDEN, bounds.shape[0])).astype(np.float32)
    params = {"params": variables["params"]}
    params64 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), params)
    out["net_forward_f64"] = np.asarray(model.apply(
        params64, jnp.asarray(out["net_x"], jnp.float64)))

    # (c) plan_batch of both modes on seeded poses near the raceline
    track = oval_track(30.0, 15.0, n_samples=512, speed=3.0)
    n = N_GOLDEN
    s = rng.uniform(0.0, float(track.raceline.length), n)
    x, y, th = track.frenet_to_cartesian(jnp.asarray(s),
                                         jnp.asarray(rng.uniform(-1, 1, n)),
                                         jnp.asarray(rng.uniform(-.5, .5, n)))
    pose = np.stack([np.asarray(x), np.asarray(y), np.asarray(th),
                     rng.uniform(0.5, 6.0, n)], axis=-1)
    out["plan_pose"] = pose
    for suffix, dt, x64 in (("f64", jnp.float64, True),
                            ("f32", jnp.float32, False)):
        with jax.enable_x64(x64):
            prm = jax.tree.map(lambda a: jnp.asarray(a, dt), params)
            planners = {"solver": GoalMPCPlanner(track),
                        "net": GoalMPCPlanner(track, model, prm)}
            for mode, planner in planners.items():
                speed, steer = planner.plan_batch(
                    *jnp.asarray(pose, dt).T)
                out[f"plan_{mode}_speed_{suffix}"] = np.asarray(speed)
                out[f"plan_{mode}_steer_{suffix}"] = np.asarray(steer)

    # (b) both closed loops, in f32 as the eval script runs them
    jax.config.update("jax_enable_x64", False)
    env, sim0, noise, mu, cs = sweep_env(track, "speed")
    params32 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), params)
    for mode, planner in (("solver", GoalMPCPlanner(track)),
                          ("net", GoalMPCPlanner(track, model, params32))):
        def policy(obs, planner=planner):
            speed, steer = planner.plan_batch(obs.pose_x, obs.pose_y,
                                              obs.pose_theta,
                                              obs.linear_vel_x)
            return jnp.stack([speed, steer], axis=-1)

        loop = run_sweep(env, sim0, policy)
        out.update({f"loop_{mode}_{k}": v for k, v in loop.items()})
    jax.config.update("jax_enable_x64", True)
    out.update(loop_noise=noise, loop_mu=mu.astype(np.float32),
               loop_cs=cs.astype(np.float32))
    return out


GOLDENS = {"goal_mpc_pr": (goal_golden, "goal_mpc_golden.npz")}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--run", default="frenet_wide_pr1")
    ap.add_argument("--golden", action="store_true",
                    help="also write the run's goldens (runs the 1000-lane "
                         "closed loops on the CPU: minutes)")
    ap.add_argument("--out_dir", default=ASSETS)
    args = ap.parse_args()
    model, variables, config = load_model(f"configs/{args.run}.yaml",
                                          f"ckpts/{args.run}")
    os.makedirs(args.out_dir, exist_ok=True)
    np.savez(os.path.join(args.out_dir, f"{args.run}.npz"),
             **flatten_tree(variables))
    with open(os.path.join(args.out_dir, f"{args.run}.json"), "w") as f:
        json.dump(config, f, indent=1, sort_keys=True)
    print(f"wrote {args.run}.npz and {args.run}.json to {args.out_dir}")
    if args.golden:
        fn, name = GOLDENS.get(args.run,
                               (frenet_golden, f"{args.run}_golden.npz"))
        np.savez_compressed(os.path.join(args.out_dir, name),
                            **fn(model, variables, config))
        print(f"wrote {name}")


if __name__ == "__main__":
    main()
