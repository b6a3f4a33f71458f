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

- with ``--bank_golden`` (reads the 12 ``bank6_pr_mu*`` runs),
  ``bank6_golden.npz``: the grip-adaptive bank (``GripAdaptiveFrenetPlanner``
  over the 12 arms sorted by mu, ``--pace_lo 0.2 --speed_scale 2.5``, the
  other flags at the eval script's defaults) on the sweep above, through
  ``rollout_stateful``, in f32: per-lane laps, done, final progress, mean
  |ey| and final grip estimate ``g``, and ``loop_arm`` (steps, lanes): the
  arm each lane drove with at each step.
- for ``cart_c1_pr`` with ``--golden``, ``cart_c1_pr_golden.npz``:
  ``plan_pose`` (x, y, theta, delta, v, beta, angv: 1024 seeded poses near
  the oval's raceline, some with theta a lap or two off) and ``plan_*``:
  the JAX ``IRBFNPlanner.plan_batch`` outputs (setpoint mode, the config's
  mirror and sv_ind) in f64; and ``loop_*``: that planner on the sweep
  above, in f32.
- with ``--map_golden`` (reads ``frenet_wide_pr1``), ``map_golden.npz``:
  the oval rasterized at half width 2.0 (``rasterize_track``),
  ``ray_pose`` (1024 seeded poses inside the corridor) and ``ray_f32`` /
  ``ray_f64``: ``trace_rays`` at the default 64-beam ``ScanSpec`` in each
  precision; ``loop_*``: the flagship on the sweep above in that map world
  (``occ_map``, ``scan_spec``, ``enable_ttc``, ``car_radius`` 0.15, no
  corridor), in f32; and ``osch_*``: the eval script's 3 x 3 flags (27
  lanes, no start noise, one attempt) on the Oschersleben line
  (``data/Oschersleben_raceline_feasible.csv``) in a map rasterized at
  half width ``osch_half_width``, for the flagship (``osch_irbfn_*``) and
  the goal-MPC solver (``osch_goal_mpc_*``): per-lane results, and per step
  the lanes' |ey|, actions and the lookahead's raceline index.

- for ``clothoid_pr`` with ``--golden`` (or ``--clothoid_golden``, which
  also writes the run), ``clothoid_golden.npz``:
    * ``goals``: every 97th goal of the default 251 x 161 x 158 LUT lattice
      (65,536 goals, f32, 'ij' order; ``goal_idx`` into the lattice), and
      ``sol_f64_*`` / ``sol_f32_*``: the JAX ``solve_g1_hermite`` solutions
      (k0, dk, length, residual, converged) of them in each precision;
    * ``forward_f64``: the flax forward of ``clothoid_pr`` on them in f64,
      and ``end_err_f64`` (65,536, 3): |x|, |y| and |wrapped theta| of
      those spirals' endpoints against the goals (``integrate_endpoint_gl``
      in f64);
    * ``plan_{net,oracle}_{free,obs}_*``: one ``LatticePlanner.plan`` of
      each mode (the net, and the exact solver), toward ``plan_target``,
      without and with the obstacles ``plan_obstacles``, in f32: costs,
      weights, best and argmin params and paths; and ``plan_net_params``,
      the net's f32 spirals of the 360 goals.
- with ``--cheap_pass_check``, the cheap-pass comparison (prints); with
  ``--out PATH`` also the JAX side as a golden (``cheap_pass_golden.npz``):
  ``rows`` (the 312 seeded rows), ``flags_f32``/``kkt_f32`` and
  ``flags_f64``/``kkt_f64`` (JAX, 39-row chunks), and ``test_idx`` (39
  rows: the seven named in ``P4_ROWS`` and the first 32 others) with
  ``test_flags_f32``/``test_kkt_f32``: JAX f32 solving those 39 as one
  batch (the port's test shape).
- with ``--cart_chain_golden``, ``cart_chain_golden.npz``: the rows of the
  cut cartesian grid of ``CART_TEST_ARGS`` (128 rows) and the JAX f64
  ``solve_cartesian_point`` solutions of every row at the three budgets of
  a tiered table made with ``CART_TEST_TIERS`` (``{cheap,full,hard}_*``:
  accel, steer_vel, feasible, kkt).

Usage (from the repo root):
    JAX_PLATFORMS=cpu python scripts/export_torch_ckpt.py --nmpc_golden   # ~6 min
    JAX_PLATFORMS=cpu python scripts/export_torch_ckpt.py --run frenet_wide_pr1 --golden
    JAX_PLATFORMS=cpu python scripts/export_torch_ckpt.py --run goal_mpc_pr --golden
    JAX_PLATFORMS=cpu python scripts/export_torch_ckpt.py --run frenet_wide_pr1 --train_golden
    JAX_PLATFORMS=cpu python scripts/export_torch_ckpt.py --run cart_c1_pr --golden
    JAX_PLATFORMS=cpu python scripts/export_torch_ckpt.py --bank_golden   # writes the 12 arms too
    JAX_PLATFORMS=cpu python scripts/export_torch_ckpt.py --map_golden
    JAX_PLATFORMS=cpu python scripts/export_torch_ckpt.py --bank_golden --nudge 1e-6  # JAX vs itself
    JAX_PLATFORMS=cpu python scripts/export_torch_ckpt.py --cheap_pass_check \
        --out irbfn_tpu_torch/assets/cheap_pass_golden.npz  # ~5 min
    JAX_PLATFORMS=cpu python scripts/export_torch_ckpt.py --clothoid_golden
    JAX_PLATFORMS=cpu python scripts/export_torch_ckpt.py --cart_chain_golden
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


# the grip-adaptive bank: the 12 arms of docs/ARTIFACTS.md's 92.0/100 run,
# on the sweep with the raceline's speed scaled (the eval script's
# --speed_scale): at the oval's 3 m/s the observer's speed gate
# (GripConfig.v_min = 3.5 m/s) never opens, every lane keeps g = g0 and
# drives one arm; at 7.5 m/s every arm is driven
BANK_MUS = (0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8, 0.9, 1.0, 1.1, 1.2)
BANK_FLAGS = dict(g0=0.5, pace_lo=0.2, pace_hi=1.0, pace_margin=1.0,
                  speed_scale=2.5)


def bank_runs():
    return [f"bank6_pr_mu{m:.2f}" for m in BANK_MUS]


def export_run(run, out_dir):
    """``<run>.npz`` (flattened flax tree) and ``<run>.json`` (the config);
    returns ``(model, variables, config)``."""
    model, variables, config = load_model(f"configs/{run}.yaml",
                                          f"ckpts/{run}")
    os.makedirs(out_dir, exist_ok=True)
    np.savez(os.path.join(out_dir, f"{run}.npz"), **flatten_tree(variables))
    with open(os.path.join(out_dir, f"{run}.json"), "w") as f:
        json.dump(config, f, indent=1, sort_keys=True)
    print(f"wrote {run}.npz and {run}.json to {out_dir}", flush=True)
    return model, variables, config


def _f32(variables):
    return jax.tree.map(lambda a: jnp.asarray(a, jnp.float32),
                        {"params": variables["params"]})


def bank_golden(out_dir, nudge=0.0):
    """The 12-arm grip-adaptive bank on the sweep, through
    ``rollout_stateful``, in f32, with every step's arm per lane. ``nudge``
    scales the start states by (1 + nudge) (and writes no arm): the JAX
    package's own sensitivity to f32-sized differences."""
    from irbfn_tpu.planning import GripAdaptiveFrenetPlanner
    from irbfn_tpu.planning.grip import GripConfig

    if nudge:
        loaded = [load_model(f"configs/{r}.yaml", f"ckpts/{r}")
                  for r in bank_runs()]
    else:
        loaded = [export_run(r, out_dir) for r in bank_runs()]
    model0, _, conf0 = loaded[0]
    jax.config.update("jax_enable_x64", False)
    track = oval_track(30.0, 15.0, n_samples=512, speed=3.0)
    rl = track.raceline
    track = track._replace(raceline=rl._replace(
        vxs=rl.vxs * BANK_FLAGS["speed_scale"]))
    env, sim0, noise, mu, cs = sweep_env(track, "accl")
    sim0 = sim0._replace(x=sim0.x * (1.0 + nudge))
    planner = GripAdaptiveFrenetPlanner(
        model0, [_f32(v) for _, v, _ in loaded], BANK_MUS, track,
        input_bounds=input_bounds_from_config(conf0),
        grip_cfg=GripConfig(g0=BANK_FLAGS["g0"]),
        pace_lo=BANK_FLAGS["pace_lo"], pace_hi=BANK_FLAGS["pace_hi"],
        pace_margin=BANK_FLAGS["pace_margin"])
    policy = planner.policy()
    n, B = LOOP["n_steps"], mu.size

    def logged(carry, obs):
        gs, t, g_log = carry
        action, gs = policy(gs, obs)
        return action, (gs, t + 1, g_log.at[t].set(gs.g))

    t0 = time.perf_counter()
    carry = (planner.init_state((B,)), jnp.int32(0),
             jnp.zeros((n, B), jnp.float32))
    final, (gs, _, g_log), traj = env.rollout_stateful(sim0, logged, carry,
                                                       n)
    ey_mean, _ = deviation_metrics(traj)
    mus = np.asarray(BANK_MUS, np.float32)
    g_log = np.asarray(g_log)
    # the planner's arm rule on the g it chose with, in the same f32 ops
    arm = np.argmin(np.abs(mus - np.clip(g_log, mus[0], mus[-1])[..., None]),
                    axis=-1).astype(np.int8)
    out = dict(loop_laps=np.asarray(final.laps),
               loop_done=np.asarray(final.done), loop_s=np.asarray(final.s),
               loop_ey_mean=np.asarray(ey_mean), loop_g=np.asarray(gs.g),
               loop_arm=arm, loop_noise=noise,
               loop_mu=mu.astype(np.float32), loop_cs=cs.astype(np.float32),
               arm_mus=mus, **{f"flag_{k}": v for k, v in BANK_FLAGS.items()})
    jax.config.update("jax_enable_x64", True)
    print(f"grip-adaptive bank: {B} lanes x {n} steps in "
          f"{time.perf_counter() - t0:.1f} s (JAX, CPU); completed "
          f"{int((~out['loop_done']).sum())}/{B}, mean|ey| "
          f"{float(out['loop_ey_mean'].mean()):.4f}, final g median "
          f"{float(np.median(out['loop_g'])):.3f}, arms used "
          f"{np.bincount(arm.reshape(-1), minlength=len(mus)).tolist()}",
          flush=True)
    return out


def cart_golden(model, variables, config):
    """IRBFNPlanner (setpoint mode) on seeded poses in f64, and on the
    sweep in f32."""
    from irbfn_tpu.planning import IRBFNPlanner

    bounds = input_bounds_from_config(config)
    kw = dict(mirror=bool(config.get("mirror", True)),
              sv_ind=int(config["out_features"]) // 2, input_bounds=bounds,
              use_pallas=False)
    track = oval_track(30.0, 15.0, n_samples=512, speed=3.0)
    rng = np.random.default_rng(0)
    n = N_GOLDEN
    s = rng.uniform(0.0, float(track.raceline.length), n)
    x, y, th = track.frenet_to_cartesian(
        jnp.asarray(s), jnp.asarray(rng.uniform(-1.0, 1.0, n)),
        jnp.asarray(rng.uniform(-0.6, 0.6, n)))
    laps = rng.integers(-1, 3, n) * 2.0 * np.pi  # theta accumulated over laps
    pose = np.stack([np.asarray(x), np.asarray(y), np.asarray(th) + laps,
                     rng.uniform(-0.3, 0.3, n), rng.uniform(0.5, 7.0, n),
                     rng.uniform(-0.15, 0.15, n), rng.uniform(-1.5, 1.5, n)],
                    axis=-1)
    params64 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64),
                            {"params": variables["params"]})
    res = IRBFNPlanner(model, params64, track, dtype=jnp.float64,
                       **kw).plan_batch(*pose.T)
    out = {"plan_pose": pose}
    out.update({f"plan_{k}": np.asarray(v) for k, v in res._asdict().items()})

    jax.config.update("jax_enable_x64", False)
    env, sim0, noise, mu, cs = sweep_env(track, "accl")
    planner = IRBFNPlanner(model, _f32(variables), track, **kw)

    def policy(obs):
        r = planner.plan_batch(obs.pose_x, obs.pose_y, obs.pose_theta,
                               obs.delta, obs.linear_vel_x, obs.beta,
                               obs.ang_vel_z)
        return jnp.stack([r.accel, r.steer_vel], axis=-1)

    loop = run_sweep(env, sim0, policy)
    jax.config.update("jax_enable_x64", True)
    out.update(loop_noise=noise, loop_mu=mu.astype(np.float32),
               loop_cs=cs.astype(np.float32),
               **{f"loop_{k}": v for k, v in loop.items()})
    return out


def lookahead_rows(points, x, y, v, horizon_time=0.5, min_lookahead=0.1):
    """(nearest, goal) raceline rows of ``_lookahead_goal`` per pose, in
    numpy f32: the rows whose yaw and speed the goal-MPC planner reads."""
    d2 = ((np.stack([x, y], -1)[:, None] - points) ** 2).sum(-1)
    near = d2.argmin(-1)
    seg = np.linalg.norm(points[1] - points[0])
    la_d = np.maximum(np.maximum(v, 0.1) * horizon_time, min_lookahead)
    goal = (near + np.ceil(la_d / seg).astype(np.int64)) % len(points)
    return np.stack([near, goal], -1)


OSCH_CSV = "data/Oschersleben_raceline_feasible.csv"
OSCH_HALF_WIDTH = 1.0  # the map rasterized around the line: a 2 m corridor
OSCH = dict(num_mu=3, mu_min=0.7, mu_max=1.1, num_cs=3, cs_min=3.0,
            cs_max=7.0, num_trials=3, n_steps=600, car_radius=0.15)


def write_bundle(omap, bundle, name):
    """A reference-format track directory from a rasterized map: the map
    yaml+png (free = positive distance) and the line CSV beside it."""
    import shutil

    from irbfn_tpu.sim.map import save_map_yaml

    os.makedirs(bundle, exist_ok=True)
    origin = (float(omap.origin_x), float(omap.origin_y), 0.0)
    save_map_yaml(np.asarray(omap.dist) > 0, float(omap.resolution), origin,
                  os.path.join(bundle, f"{name}_map.yaml"))
    shutil.copy(OSCH_CSV, os.path.join(bundle, f"{name}_raceline.csv"))


def osch_loops(model, variables, config, bundle):
    """The eval script's flagship and goal-MPC sweeps on the Oschersleben
    line in the bundle's map world, no start noise, one attempt, f32."""
    from irbfn_tpu.sim.map import load_track_bundle, raceline_from_csv
    from irbfn_tpu.sim.track import Track

    _, omap = load_track_bundle(bundle)
    track = Track(raceline_from_csv(OSCH_CSV))
    rl = track.raceline
    mus = np.linspace(OSCH["mu_min"], OSCH["mu_max"], OSCH["num_mu"])
    css = np.linspace(OSCH["cs_min"], OSCH["cs_max"], OSCH["num_cs"])
    mu_g, cs_g = np.meshgrid(mus, css, indexing="ij")
    mu = np.repeat(mu_g.reshape(-1), OSCH["num_trials"])
    cs = np.repeat(cs_g.reshape(-1), OSCH["num_trials"])
    B = mu.size
    base = f1tenth_params()
    full = lambda v: jnp.full((B,), v, jnp.float32)  # noqa: E731
    params_b = VehicleParams(
        mu=jnp.asarray(mu, jnp.float32), m=full(base.m), I=full(base.I),
        lf=full(base.lf), lr=full(base.lr), C_Sf=jnp.asarray(cs, jnp.float32),
        C_Sr=jnp.asarray(cs, jnp.float32), h=full(base.h), dt=full(0.01),
        sv_max=full(base.sv_max), a_max=full(base.a_max),
        s_max=full(base.s_max), v_max=full(base.v_max))
    flagship = IRBFNFrenetPlanner(model, _f32(variables), track,
                                  use_pallas=False,
                                  input_bounds=input_bounds_from_config(config))
    goal = GoalMPCPlanner(track)
    out = {}
    for name, mode in (("irbfn", "accl"), ("goal_mpc", "speed")):
        env = TrackEnv(track, params_b, half_width=None, occ_map=omap,
                       car_radius=OSCH["car_radius"], control_mode=mode)
        sim = env.reset(s0=jnp.zeros(B), speed0=1.0, batch_shape=(B,))
        eys, acts, idx = [], [], []
        t0 = time.perf_counter()
        for _ in range(OSCH["n_steps"]):
            obs = env.observe(sim)
            if name == "irbfn":
                r = flagship.plan_batch(obs.s, obs.ey, obs.epsi, obs.delta,
                                        obs.linear_vel_x, obs.linear_vel_y,
                                        obs.ang_vel_z)
                action = jnp.stack([r.accel, r.steer_vel], axis=-1)
            else:
                action = jnp.stack(goal.plan_batch(
                    obs.pose_x, obs.pose_y, obs.pose_theta,
                    obs.linear_vel_x), axis=-1)
            eys.append(np.asarray(obs.ey))
            acts.append(np.asarray(action))
            idx.append(lookahead_rows(np.asarray(rl.points),
                                      np.asarray(obs.pose_x),
                                      np.asarray(obs.pose_y),
                                      np.asarray(obs.linear_vel_x)))
            sim = env.step(sim, action)
        ey = np.abs(np.stack(eys))
        out.update({f"osch_{name}_laps": np.asarray(sim.laps),
                    f"osch_{name}_done": np.asarray(sim.done),
                    f"osch_{name}_s": np.asarray(sim.s),
                    f"osch_{name}_abs_ey": ey.astype(np.float32),
                    f"osch_{name}_action": np.stack(acts).astype(np.float32),
                    f"osch_{name}_rows": np.stack(idx).astype(np.int16)})
        print(f"Oschersleben {name}: {B} lanes x {OSCH['n_steps']} steps in "
              f"{time.perf_counter() - t0:.1f} s (JAX, CPU); completed "
              f"{int((~np.asarray(sim.done)).sum())}/{B}, laps "
              f"{np.asarray(sim.laps).tolist()}", flush=True)
    out.update(osch_mu=mu.astype(np.float32), osch_cs=cs.astype(np.float32),
               osch_half_width=OSCH_HALF_WIDTH,
               **{f"osch_flag_{k}": v for k, v in OSCH.items()})
    return out


# the reference-parity Frenet lattice (docs/ARTIFACTS.md: 8x5x9x7x5x7x9x3
# over the generator's default ranges) and the tiered generator's cheap pass
PARITY_GRID = (("ey", -0.2, 2.0, 8), ("delta", -0.3, 0.3, 5),
               ("vx_car", 1.0, 7.0, 9), ("vy_car", -1.0, 1.0, 7),
               ("vx_goal", 3.0, 7.0, 5), ("wz", -2.6, 2.6, 7),
               ("epsi", -1.0, 1.0, 9), ("curv", -0.1, 0.1, 3))
CHEAP_ITERS = 12
CHEAP_ROWS = 8 * NMPC_CHUNK  # seeded lattice rows, in 39-row solves
# rows of the sample whose f32 flags parted from the JAX package's
P4_ROWS = (20, 66, 67, 102, 128, 161, 175)


def cheap_pass_test_idx():
    """The port's 39-row test shape: ``P4_ROWS`` and the first 32 others."""
    others = [i for i in range(CHEAP_ROWS) if i not in P4_ROWS]
    return np.asarray(sorted(list(P4_ROWS) + others[:NMPC_CHUNK - 7]))


def cheap_pass_check(out_path=None):
    """The tiered table generator's cheap pass (Newton iterations capped at
    12) on seeded rows of the reference-parity lattice, in f32 and in f64,
    through the JAX package and the port on the CPU: certificate flags row
    by row, and the KKT residuals of the rows whose flags differ. With
    ``out_path``, the JAX side is written there as a golden."""
    import torch

    from irbfn_tpu.dynamics.params import fullscale_params
    from irbfn_tpu.solvers.nmpc import NMPCConfig, solve_lattice_point
    from irbfn_tpu_torch.dynamics import fullscale_params as t_fullscale
    from irbfn_tpu_torch.solvers import nmpc as tnmpc

    lattice = build_lattice(tuple(GridSpec(*g) for g in PARITY_GRID),
                            dtype=np.float32)
    rng = np.random.default_rng(0)
    rows = lattice[np.sort(rng.choice(len(lattice), CHEAP_ROWS,
                                      replace=False))]
    chunks = range(0, CHEAP_ROWS, NMPC_CHUNK)
    cfg_j, cfg_t = (NMPCConfig(gn_iters=CHEAP_ITERS),
                    tnmpc.NMPCConfig(gn_iters=CHEAP_ITERS))
    golden = {"rows": rows}
    for name, x64, jdt, tdt in (("f32", False, jnp.float32, torch.float32),
                                ("f64", True, jnp.float64, torch.float64)):
        t0 = time.perf_counter()
        with jax.enable_x64(x64):
            params = fullscale_params(dtype=jdt)
            sols = [solve_lattice_point(jnp.asarray(rows[i:i + NMPC_CHUNK],
                                                    jdt), params, cfg_j)
                    for i in chunks]
            flags_j = np.concatenate([np.asarray(s.feasible) for s in sols])
            kkt_j = np.concatenate([np.asarray(s.kkt_residual)
                                    for s in sols])
            golden.update({f"flags_{name}": flags_j, f"kkt_{name}": kkt_j})
            if name == "f32":
                idx = cheap_pass_test_idx()
                s = solve_lattice_point(jnp.asarray(rows[idx], jdt), params,
                                        cfg_j)
                golden.update(test_idx=idx,
                              test_flags_f32=np.asarray(s.feasible),
                              test_kkt_f32=np.asarray(s.kkt_residual))
        t_j = time.perf_counter() - t0
        t0 = time.perf_counter()
        tparams = t_fullscale(dtype=tdt, device="cpu")
        sols = [tnmpc.solve_lattice_point(
            torch.as_tensor(rows[i:i + NMPC_CHUNK], dtype=tdt), tparams,
            cfg_t, device="cpu") for i in chunks]
        flags_t = np.concatenate([s.feasible.numpy() for s in sols])
        kkt_t = np.concatenate([s.kkt_residual.numpy() for s in sols])
        t_t = time.perf_counter() - t0
        diff = np.flatnonzero(flags_j != flags_t)
        print(f"cheap pass ({CHEAP_ITERS}-iteration cap, {name}) on "
              f"{CHEAP_ROWS} seeded rows of the {len(lattice):,}-row "
              f"reference-parity lattice: JAX certifies {flags_j.mean():.4f}"
              f" ({t_j:.0f} s), the port {flags_t.mean():.4f} ({t_t:.0f} s);"
              f" flags differ on {diff.size} rows (JAX only "
              f"{int((flags_j & ~flags_t).sum())}, port only "
              f"{int((flags_t & ~flags_j).sum())}); their KKT residuals "
              f"(tolerance {cfg_t.kkt_tol}) JAX / port: "
              + ", ".join(f"{kkt_j[i]:.3g}/{kkt_t[i]:.3g}" for i in diff)
              + f"; KKT residual |JAX - port| median "
              f"{np.median(np.abs(kkt_j - kkt_t)):.2e}", flush=True)
    if out_path:
        np.savez_compressed(out_path, **golden)
        print(f"wrote {out_path}")


CLOTHOID_STRIDE = 97  # 6,384,938 // 65,536
CLOTHOID_N = 65536
PLAN_TARGET = (12.0, 1.5)
PLAN_OBSTACLES = ((6.0, 0.5), (9.0, -2.0))


def clothoid_golden(model, variables, config):
    """See the module docstring (``clothoid_golden.npz``)."""
    from irbfn_tpu.dynamics import integrate_endpoint_gl
    from irbfn_tpu.parallel import CLOTHOID_GRID
    from irbfn_tpu.planning.lattice import LatticePlanner
    from irbfn_tpu.solvers.clothoid import solve_g1_hermite, wrap_angle

    lattice = build_lattice(CLOTHOID_GRID, dtype=np.float32)
    idx = np.arange(0, len(lattice), CLOTHOID_STRIDE)[:CLOTHOID_N]
    goals = lattice[idx]
    out = {"goals": goals, "goal_idx": idx}
    for name, x64, dt in (("f64", True, jnp.float64),
                          ("f32", False, jnp.float32)):
        with jax.enable_x64(x64):
            g = jnp.asarray(goals, dt)
            sol = solve_g1_hermite(g[:, 0], g[:, 1], g[:, 2])
            out.update({f"sol_{name}_{k}": np.asarray(getattr(sol, k))
                        for k in sol._fields})
    # the committed net in f64, in chunks (R=128 x K=256 features per row)
    v64 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64),
                       {"params": variables["params"]})
    apply = jax.jit(lambda x: model.apply(v64, x))
    fwd = np.concatenate([np.asarray(apply(jnp.asarray(goals[i:i + 2048],
                                                        jnp.float64)))
                          for i in range(0, CLOTHOID_N, 2048)])
    end = np.asarray(integrate_endpoint_gl(jnp.asarray(fwd)))
    g64 = goals.astype(np.float64)
    out["forward_f64"] = fwd
    out["end_err_f64"] = np.stack([
        np.abs(end[:, 0] - g64[:, 0]), np.abs(end[:, 1] - g64[:, 1]),
        np.abs(np.asarray(wrap_angle(jnp.asarray(end[:, 2] - g64[:, 2]))))],
        axis=-1)
    print(f"clothoid golden: {CLOTHOID_N:,} goals solved in f64 and f32, "
          f"the net's endpoint |x| mean {out['end_err_f64'][:, 0].mean():.4f}"
          f", |y| mean {out['end_err_f64'][:, 1].mean():.4f}", flush=True)
    out.update(plan_target=np.asarray(PLAN_TARGET, np.float32),
               plan_obstacles=np.asarray(PLAN_OBSTACLES, np.float32))
    with jax.enable_x64(False):
        planners = {"net": LatticePlanner(model, _f32(variables)),
                    "oracle": LatticePlanner()}
        for mode, planner in planners.items():
            for case, obs in (("free", None), ("obs", PLAN_OBSTACLES)):
                plan = planner.plan(PLAN_TARGET, obs)
                for k in ("costs", "weights", "best_params", "argmin_params",
                          "best_path", "argmin_path"):
                    out[f"plan_{mode}_{case}_{k}"] = np.asarray(
                        getattr(plan, k))
        out["plan_goals"] = np.asarray(planners["net"].goals)
        out["plan_net_params"] = np.asarray(
            planners["net"]._param_fn(planners["net"].goals))
    return out


# a cut cartesian grid (2 values per axis: 128 rows) and the budgets of its
# tiered table: cheap pass cap, then gn_iters/al_outer, resolve factor
CART_TEST_ARGS = ("--v_car_min", "1", "--v_car_max", "5", "--d_v_car", "4",
                  "--x_goal_min", "1", "--x_goal_max", "3", "--d_x_goal", "2",
                  "--y_goal_min", "0", "--y_goal_max", "2", "--d_y_goal", "2",
                  "--t_goal_min", "-1", "--t_goal_max", "1", "--d_t_goal",
                  "2", "--v_goal_min", "1", "--v_goal_max", "5", "--d_v_goal",
                  "4", "--beta_min", "-0.2", "--beta_max", "0.2", "--d_beta",
                  "0.4", "--angv_z_min", "-1", "--angv_z_max", "1",
                  "--d_angv_z", "2")
CART_TEST_TIERS = dict(phase1_iters=3, gn_iters=8, al_outer=2,
                       resolve_factor=2)


def cart_chain_golden():
    """See the module docstring (``cart_chain_golden.npz``)."""
    from irbfn_tpu.solvers import cartesian_config, solve_cartesian_point

    vals = dict(zip(CART_TEST_ARGS[::2], CART_TEST_ARGS[1::2]))
    dims = ("v_car", "x_goal", "y_goal", "t_goal", "v_goal", "beta",
            "angv_z")
    grid = []
    for d in dims:
        lo, hi = float(vals[f"--{d}_min"]), float(vals[f"--{d}_max"])
        num = int(round((hi - lo) / float(vals[f"--d_{d}"]))) + 1
        grid.append(GridSpec(d, lo, hi, num))
    rows = build_lattice(tuple(grid), dtype=np.float64)
    tiers = CART_TEST_TIERS
    cfgs = {"cheap": cartesian_config(gn_iters=tiers["phase1_iters"],
                                      al_outer=tiers["al_outer"]),
            "full": cartesian_config(gn_iters=tiers["gn_iters"],
                                     al_outer=tiers["al_outer"]),
            "hard": cartesian_config(
                gn_iters=tiers["gn_iters"] * tiers["resolve_factor"],
                al_outer=tiers["al_outer"] + 2)}
    out = {"rows": rows}
    params = f1tenth_params(dtype=jnp.float64)
    for name, cfg in cfgs.items():
        t0 = time.perf_counter()
        sol = solve_cartesian_point(jnp.asarray(rows), params, cfg)
        out.update({f"{name}_accel": np.asarray(sol.accel),
                    f"{name}_steer_vel": np.asarray(sol.steer_vel),
                    f"{name}_feasible": np.asarray(sol.feasible),
                    f"{name}_kkt": np.asarray(sol.kkt_residual)})
        print(f"cartesian {name} pass on {len(rows)} rows: "
              f"{np.asarray(sol.feasible).mean():.3f} feasible "
              f"({time.perf_counter() - t0:.0f} s)", flush=True)
    return out


N_RAYS = 1024


def map_golden(out_dir):
    """trace_rays on seeded poses, the flagship in the oval's map world,
    and the Oschersleben sweeps (see the module docstring)."""
    import tempfile

    from irbfn_tpu.sim.map import ScanSpec, rasterize_track, trace_rays
    from irbfn_tpu.sim.map import raceline_from_csv
    from irbfn_tpu.sim.track import Track

    model, variables, config = load_model("configs/frenet_wide_pr1.yaml",
                                          "ckpts/frenet_wide_pr1")
    track = oval_track(30.0, 15.0, n_samples=512, speed=3.0)
    omap = rasterize_track(track, half_width=LOOP["half_width"])
    rng = np.random.default_rng(0)
    s = rng.uniform(0.0, float(track.raceline.length), N_RAYS)
    x, y, th = track.frenet_to_cartesian(
        jnp.asarray(s), jnp.asarray(rng.uniform(-1.8, 1.8, N_RAYS)),
        jnp.asarray(rng.uniform(-np.pi, np.pi, N_RAYS)))
    pose = np.stack([np.asarray(x), np.asarray(y), np.asarray(th)],
                    -1).astype(np.float32)
    out = {"ray_pose": pose}
    for suffix, dt in (("f32", jnp.float32), ("f64", jnp.float64)):
        om = omap._replace(**{k: jnp.asarray(getattr(omap, k), dt)
                              for k in omap._fields})
        out[f"ray_{suffix}"] = np.asarray(trace_rays(
            om, *(jnp.asarray(pose[:, i], dt) for i in range(3)),
            ScanSpec()))

    jax.config.update("jax_enable_x64", False)
    env, sim0, noise, mu, cs = sweep_env(track, "accl")
    env = TrackEnv(track, env.params, half_width=None, occ_map=omap,
                   car_radius=OSCH["car_radius"], scan_spec=ScanSpec(),
                   enable_ttc=True)
    planner = IRBFNFrenetPlanner(model, _f32(variables), track,
                                 use_pallas=False,
                                 input_bounds=input_bounds_from_config(config))

    def policy(obs):
        r = planner.plan_batch(obs.s, obs.ey, obs.epsi, obs.delta,
                               obs.linear_vel_x, obs.linear_vel_y,
                               obs.ang_vel_z)
        return jnp.stack([r.accel, r.steer_vel], axis=-1)

    loop = run_sweep(env, sim0, policy)
    out.update(loop_noise=noise, loop_mu=mu.astype(np.float32),
               loop_cs=cs.astype(np.float32),
               **{f"loop_{k}": v for k, v in loop.items()})
    with tempfile.TemporaryDirectory() as d:
        osch = Track(raceline_from_csv(OSCH_CSV))
        write_bundle(rasterize_track(osch, half_width=OSCH_HALF_WIDTH),
                     os.path.join(d, "osch"), "osch")
        out.update(osch_loops(model, variables, config,
                              os.path.join(d, "osch")))
    jax.config.update("jax_enable_x64", True)
    return out


GOLDENS = {"goal_mpc_pr": (goal_golden, "goal_mpc_golden.npz")}
GOLDENS["cart_c1_pr"] = (cart_golden, "cart_c1_pr_golden.npz")
GOLDENS["clothoid_pr"] = (clothoid_golden, "clothoid_golden.npz")


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
    ap.add_argument("--bank_golden", action="store_true",
                    help="write the 12 bank6_pr_mu* arms and "
                         "bank6_golden.npz (the grip-adaptive sweep) and "
                         "stop")
    ap.add_argument("--map_golden", action="store_true",
                    help="write map_golden.npz (scans, the flagship in "
                         "the oval's map world, the Oschersleben sweeps) "
                         "and stop")
    ap.add_argument("--cheap_pass_check", action="store_true",
                    help="compare the tiered generator's cheap-pass "
                         "certificate flags of the two packages on seeded "
                         "lattice rows (prints; writes nothing) and stop")
    ap.add_argument("--out", default=None,
                    help="with --cheap_pass_check: write the JAX side as a "
                         "golden to this path")
    ap.add_argument("--clothoid_golden", action="store_true",
                    help="write clothoid_pr and clothoid_golden.npz, and "
                         "stop")
    ap.add_argument("--cart_chain_golden", action="store_true",
                    help="write cart_chain_golden.npz (reads no "
                         "checkpoint) and stop")
    ap.add_argument("--nudge", type=float, default=0.0,
                    help="with --bank_golden: scale the start states by "
                         "(1 + nudge) and compare with the committed golden "
                         "instead of writing one")
    ap.add_argument("--out_dir", default=ASSETS)
    args = ap.parse_args()
    os.makedirs(args.out_dir, exist_ok=True)
    if args.cheap_pass_check:
        cheap_pass_check(args.out)
        return
    if args.clothoid_golden:
        args.run, args.golden = "clothoid_pr", True
    if args.bank_golden and args.nudge:
        out = bank_golden(args.out_dir, args.nudge)
        with np.load(os.path.join(args.out_dir, "bank6_golden.npz")) as z:
            ref = {k: z[k] for k in z.files}
        same = out["loop_arm"] == ref["loop_arm"]
        d_ey = 1e3 * np.abs(out["loop_ey_mean"] - ref["loop_ey_mean"])
        d_g = np.abs(out["loop_g"] - ref["loop_g"])
        print(f"JAX against its golden, start states x(1 + {args.nudge:g}):"
              f" arm equal in {same.mean():.4f} of lane-steps "
              f"({same[:60].mean():.4f} over the first 60), "
              f"{int((~same.all(0)).sum())} lanes differ somewhere; done "
              f"differs in {int((out['loop_done'] != ref['loop_done']).sum())}"
              f" lanes, laps in {int((out['loop_laps'] != ref['loop_laps']).sum())}"
              f"; per-lane mean |ey| median {np.median(d_ey):.3f} mm, max "
              f"{d_ey.max():.1f} mm; sweep {1e3 * abs(out['loop_ey_mean'].mean() - ref['loop_ey_mean'].mean()):.3f}"
              f" mm; final g median {np.median(d_g):.2e}, 90th percentile "
              f"{np.percentile(d_g, 90):.2e}", flush=True)
        return
    for flag, fn, name in (("nmpc_golden", nmpc_golden, "nmpc_golden.npz"),
                           ("cart_chain_golden", cart_chain_golden,
                            "cart_chain_golden.npz"),
                           ("bank_golden", bank_golden, "bank6_golden.npz"),
                           ("map_golden", map_golden, "map_golden.npz")):
        if getattr(args, flag):
            out = (fn() if flag in ("nmpc_golden", "cart_chain_golden")
                   else fn(args.out_dir))
            np.savez_compressed(os.path.join(args.out_dir, name), **out)
            print(f"wrote {name}")
            return
    model, variables, config = export_run(args.run, args.out_dir)
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
