#!/usr/bin/env python
"""Export a committed JAX checkpoint for the PyTorch port, with goldens.

Needs JAX (it reads the YAML config and the orbax checkpoint through
``irbfn_tpu.train.load_model``) and the port (whose ``flatten_tree`` fixes
the npz layout). Writes to ``irbfn_tpu_torch/assets/``:

- ``<run>.npz``  — the flax parameter tree, keys like ``params/core/centers``
- ``<run>.json`` — the YAML config as JSON
- ``<run>_golden.npz`` (``--golden``) — what ``chip_smoke.py`` holds the
  port against on the card:
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

Usage (from the repo root):
    JAX_PLATFORMS=cpu python scripts/export_torch_ckpt.py --run frenet_wide_pr1 --golden
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
from irbfn_tpu.planning import IRBFNFrenetPlanner  # noqa: E402
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


def golden(model, variables, config):
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
    env = TrackEnv(track, params_b, half_width=LOOP["half_width"])
    noise = np.random.default_rng(LOOP["seed"]).standard_normal(
        (B, 3)).astype(np.float32)
    sim0 = env.reset(s0=jnp.zeros(B), speed0=1.0, batch_shape=(B,))
    # reset's pose noise, from numpy draws instead of a jax key
    dn = LOOP["noise_scale"] * jnp.asarray(noise)
    xs = sim0.x.at[:, 0].add(dn[:, 0]).at[:, 1].add(dn[:, 1])
    sim0 = sim0._replace(x=xs.at[:, 4].add(dn[:, 2]))
    params32 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), variables)
    planner32 = IRBFNFrenetPlanner(model, params32, track, use_pallas=False,
                                   input_bounds=bounds)

    def policy(obs):
        r = planner32.plan_batch(obs.s, obs.ey, obs.epsi, obs.delta,
                                 obs.linear_vel_x, obs.linear_vel_y,
                                 obs.ang_vel_z)
        return jnp.stack([r.accel, r.steer_vel], axis=-1)

    t0 = time.perf_counter()
    final, traj = env.rollout(sim0, policy, n_steps=LOOP["n_steps"])
    ey_mean, _ = deviation_metrics(traj)
    jax.block_until_ready(ey_mean)
    print(f"closed loop: {B} lanes x {LOOP['n_steps']} steps in "
          f"{time.perf_counter() - t0:.1f} s (JAX, CPU)")
    jax.config.update("jax_enable_x64", True)
    out.update(loop_noise=noise, loop_mu=mu.astype(np.float32),
               loop_cs=cs.astype(np.float32),
               loop_laps=np.asarray(final.laps),
               loop_done=np.asarray(final.done),
               loop_s=np.asarray(final.s),
               loop_ey_mean=np.asarray(ey_mean))
    print(f"completed {int((~out['loop_done']).sum())}/{B}, "
          f"laps>=1 {int((out['loop_laps'] >= 1).sum())}, mean|ey| over "
          f"lanes {float(np.nanmean(out['loop_ey_mean'])):.4f}")
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--run", default="frenet_wide_pr1")
    ap.add_argument("--golden", action="store_true",
                    help="also write <run>_golden.npz (runs the 1000-lane "
                         "closed loop on the CPU, about a minute)")
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
        np.savez_compressed(
            os.path.join(args.out_dir, f"{args.run}_golden.npz"),
            **golden(model, variables, config))
        print(f"wrote {args.run}_golden.npz")


if __name__ == "__main__":
    main()
