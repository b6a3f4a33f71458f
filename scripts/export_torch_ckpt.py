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

- with ``--train_golden`` (a Frenet net), ``<run>_train_golden.npz``: a
  numerical fixture for the port's trainer, not data. A seeded batch of
  1,024 rows (``x`` by ``draw_inputs``; targets ``y`` = the net's own f64
  output plus seeded noise of scale 0.05), and in f64 from the JAX package:
  ``loss``, ``pred_loss``, ``int_loss`` of ``frenet_fullint_loss``, its
  gradient with respect to every parameter as ``grad_norm_<name>`` and a
  strided sample ``grad_sample_<name>`` (every ``grad_stride_<name>``-th
  element of the flattened gradient; names are the port's ``state_dict``
  keys), and ``step_losses``: the losses of 5 Adam steps on that batch
  (``lr``, ``max_grad_norm``; the loss of step i is taken before its
  update).

- with ``--nmpc_golden`` (no checkpoint is read), ``nmpc_golden.npz``, what
  ``chip_smoke.py`` holds the port's NMPC solver against:
    * ``rows``: 234 rows drawn by seed from the flagship "wide" table's
      ranges, and ``sol_*``: the JAX ``solve_lattice_point`` solutions of
      them in f64 at the default budgets, solved in chunks of 39 rows (one
      compiled program);
    * ``oracle_*``: the 100 stored SLSQP rows and solutions of
      ``tests/oracles/nmpc_frenet_slsqp.npz``, copied;
    * ``loop_*``: a short NMPC-in-the-loop run of the JAX ``NMPCPlanner``
      (f64 solves at ``loop_gn_iters`` x ``loop_al_outer``, its own shifted
      warm start) on 39 lanes of the eval sweep for ``loop_steps`` control
      steps on the oval: per step the observation the planner saw
      (``loop_obs``: s, ey, epsi, delta, vx, vy, wz), its first action
      (``loop_action``) and its feasibility flags;
    * ``meta_*``: the seeds and the versions of jax, jaxlib and numpy.

Usage (from the repo root):
    JAX_PLATFORMS=cpu python scripts/export_torch_ckpt.py --nmpc_golden   # ~6 min
    JAX_PLATFORMS=cpu python scripts/export_torch_ckpt.py --run frenet_wide_pr1 --golden
    JAX_PLATFORMS=cpu python scripts/export_torch_ckpt.py --run goal_mpc_pr --golden
    JAX_PLATFORMS=cpu python scripts/export_torch_ckpt.py --run frenet_wide_pr1 --train_golden
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
from irbfn_tpu.train import create_train_state  # noqa: E402
from irbfn_tpu.train import frenet_fullint_loss  # noqa: E402
from irbfn_tpu.train import input_bounds_from_config, load_model  # noqa: E402
from irbfn_tpu.train import make_train_step  # noqa: E402
from irbfn_tpu_torch.train import flatten_tree  # noqa: E402  (the npz format)
from irbfn_tpu_torch.train import params_from_jax  # noqa: E402

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


TRAIN = dict(rows=N_GOLDEN, noise=0.05, seed=1, lr=1e-4, max_grad_norm=1.0,
             steps=5, max_sample=4096)


def train_golden(model, variables, config):
    """The f64 loss, gradient and Adam-step fixture of a Frenet net."""
    rng = np.random.default_rng(TRAIN["seed"])
    bounds = input_bounds_from_config(config)
    x, _ = draw_inputs(bounds, 1.0, rng)
    params = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64),
                          {"params": variables["params"]})
    x64 = jnp.asarray(x, jnp.float64)
    y = np.asarray(model.apply(params, x64)) + TRAIN["noise"] * (
        rng.standard_normal((x.shape[0], config["out_features"])))
    dyn = f1tenth_params(mu=config.get("mu", 1.0), cs=config.get("cs", 5.0),
                         dtype=jnp.float64).to_vector()

    def apply_fn(p, xb):
        return model.apply({"params": p["params"]}, xb)

    def lf(p):
        return frenet_fullint_loss(apply_fn, p, x64, jnp.asarray(y), dyn)

    (loss, (pred_loss, int_loss)), grads = jax.value_and_grad(
        lf, has_aux=True)(params)
    out = dict(x=x, y=y, dyn=np.asarray(dyn), loss=np.asarray(loss),
               pred_loss=np.asarray(pred_loss), int_loss=np.asarray(int_loss),
               lr=TRAIN["lr"], max_grad_norm=TRAIN["max_grad_norm"])
    for name, g in params_from_jax(jax.tree.map(np.asarray, grads),
                                   config).items():
        g = g.numpy().reshape(-1)
        stride = max(1, -(-g.size // TRAIN["max_sample"]))
        out[f"grad_norm_{name}"] = np.linalg.norm(g)
        out[f"grad_stride_{name}"] = stride
        out[f"grad_sample_{name}"] = g[::stride]
    state = create_train_state(model, jax.random.PRNGKey(0), x64[:8],
                               lr=TRAIN["lr"],
                               max_grad_norm=TRAIN["max_grad_norm"])
    state = state.replace(params=params)
    state = state.replace(opt_state=state.tx.init(state.params))
    step = make_train_step(frenet_fullint_loss, dyn, donate=False)
    losses = []
    for _ in range(TRAIN["steps"]):
        state, m = step(state, x64, jnp.asarray(y))
        losses.append(float(m.loss))
    out["step_losses"] = np.asarray(losses)
    print(f"train golden: loss {float(loss):.6f} (pred {float(pred_loss):.6f}"
          f", int {float(int_loss):.6f}); grad norms "
          + ", ".join(f"{k[10:]} {float(v):.4g}" for k, v in out.items()
                      if k.startswith("grad_norm_"))
          + f"; step losses {losses}", flush=True)
    return out


NMPC_SEED = 0
NMPC_CHUNK = 39  # rows per JAX solve: one program shape
NMPC_CHUNKS = 6
NMPC_LOOP = dict(gn_iters=10, al_outer=2, steps=4)


def nmpc_golden() -> dict:
    """JAX f64 NMPC solutions of seeded wide-range rows, the stored SLSQP
    oracle, and a short NMPC-in-the-loop run."""
    import jaxlib

    from irbfn_tpu.dynamics.params import fullscale_params
    from irbfn_tpu.planning import NMPCPlanner
    from irbfn_tpu.solvers.nmpc import NMPCConfig, solve_lattice_point
    from irbfn_tpu_torch.parallel.gen_nmpc_table_frenet import wide_rows

    params = fullscale_params(dtype=jnp.float64)
    rows = wide_rows(NMPC_CHUNK * NMPC_CHUNKS, NMPC_SEED, np.float64)
    t0 = time.perf_counter()
    sols = [solve_lattice_point(jnp.asarray(rows[i:i + NMPC_CHUNK]), params,
                                NMPCConfig())
            for i in range(0, len(rows), NMPC_CHUNK)]
    out = {f"sol_{k}": np.concatenate([np.asarray(getattr(s, k))
                                       for s in sols])
           for k in sols[0]._fields}
    out["rows"] = rows
    print(f"{len(rows)} wide-range rows in f64: "
          f"{100 * out['sol_feasible'].mean():.1f}% feasible, "
          f"{time.perf_counter() - t0:.0f} s (JAX, CPU)", flush=True)
    with np.load("tests/oracles/nmpc_frenet_slsqp.npz") as z:
        out.update({f"oracle_{k}": z[k] for k in
                    ("rows", "u", "objective", "max_violation", "feasible")})

    # NMPC in the loop: 39 lanes spread over the eval sweep, env in f32,
    # the planner's solves in f64
    jax.config.update("jax_enable_x64", False)
    track = oval_track(30.0, 15.0, n_samples=512, speed=3.0)
    mu, cs = sweep_lanes()
    lanes = np.linspace(0, mu.size - 1, NMPC_CHUNK).round().astype(int)
    base = f1tenth_params()
    B = lanes.size
    full = lambda v: jnp.full((B,), v, jnp.float32)  # noqa: E731
    params_b = VehicleParams(
        mu=jnp.asarray(mu[lanes], jnp.float32), m=full(base.m),
        I=full(base.I), lf=full(base.lf), lr=full(base.lr),
        C_Sf=jnp.asarray(cs[lanes], jnp.float32),
        C_Sr=jnp.asarray(cs[lanes], jnp.float32), h=full(base.h),
        dt=full(0.01), sv_max=full(base.sv_max), a_max=full(base.a_max),
        s_max=full(base.s_max), v_max=full(base.v_max))
    env = TrackEnv(track, params_b, half_width=LOOP["half_width"])
    noise = np.random.default_rng(LOOP["seed"]).standard_normal(
        (mu.size, 3)).astype(np.float32)[lanes]
    sim = env.reset(s0=jnp.zeros(B), speed0=1.0, batch_shape=(B,))
    dn = LOOP["noise_scale"] * jnp.asarray(noise)
    xs = sim.x.at[:, 0].add(dn[:, 0]).at[:, 1].add(dn[:, 1])
    sim = sim._replace(x=xs.at[:, 4].add(dn[:, 2]))
    jax.config.update("jax_enable_x64", True)
    cfg = NMPCConfig(gn_iters=NMPC_LOOP["gn_iters"],
                     al_outer=NMPC_LOOP["al_outer"])
    planner = NMPCPlanner(track, params, cfg)
    obs_log, act_log, feas_log = [], [], []
    for _ in range(NMPC_LOOP["steps"]):
        o = env.observe(sim)
        obs7 = [o.s, o.ey, o.epsi, o.delta, o.linear_vel_x, o.linear_vel_y,
                o.ang_vel_z]
        sol = planner.plan_batch(*(jnp.asarray(a, jnp.float64)
                                   for a in obs7))
        action = jnp.stack([sol.accel[:, 0], sol.steer_vel[:, 0]], axis=-1)
        obs_log.append(np.stack([np.asarray(a) for a in obs7], -1))
        act_log.append(np.asarray(action))
        feas_log.append(np.asarray(sol.feasible))
        sim = env.step(sim, action.astype(jnp.float32))
    out.update(loop_obs=np.stack(obs_log), loop_action=np.stack(act_log),
               loop_feasible=np.stack(feas_log), loop_lanes=lanes,
               loop_mu=mu[lanes].astype(np.float32),
               loop_cs=cs[lanes].astype(np.float32), loop_noise=noise,
               loop_gn_iters=NMPC_LOOP["gn_iters"],
               loop_al_outer=NMPC_LOOP["al_outer"],
               loop_steps=NMPC_LOOP["steps"], meta_seed=NMPC_SEED,
               meta_loop_seed=LOOP["seed"], meta_jax=jax.__version__,
               meta_jaxlib=jaxlib.__version__, meta_numpy=np.__version__)
    print(f"NMPC in the loop: {B} lanes x {NMPC_LOOP['steps']} steps, "
          f"feasible {100 * np.mean(feas_log):.1f}%", flush=True)
    return out


GOLDENS = {"goal_mpc_pr": (goal_golden, "goal_mpc_golden.npz")}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--run", default="frenet_wide_pr1")
    ap.add_argument("--golden", action="store_true",
                    help="also write the run's goldens (runs the 1000-lane "
                         "closed loops on the CPU: minutes)")
    ap.add_argument("--train_golden", action="store_true",
                    help="also write <run>_train_golden.npz, the trainer's "
                         "f64 loss, gradient and Adam-step fixture")
    ap.add_argument("--nmpc_golden", action="store_true",
                    help="write nmpc_golden.npz (the NMPC solver's f64 "
                         "solutions; reads no checkpoint) and stop")
    ap.add_argument("--out_dir", default=ASSETS)
    args = ap.parse_args()
    if args.nmpc_golden:
        os.makedirs(args.out_dir, exist_ok=True)
        np.savez_compressed(os.path.join(args.out_dir, "nmpc_golden.npz"),
                            **nmpc_golden())
        print("wrote nmpc_golden.npz")
        return
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
    if args.train_golden:
        name = f"{args.run}_train_golden.npz"
        np.savez_compressed(os.path.join(args.out_dir, name),
                            **train_golden(model, variables, config))
        print(f"wrote {name}")


if __name__ == "__main__":
    main()
