"""Where the port's paths spend their time on the card.

``python -m irbfn_tpu_torch.utils.profiling [--steps 30] [--warmup 20]``
runs on one CUDA card and prints, for each closed loop at the eval sweep's
1000 lanes (the Frenet planner with ``frenet_wide_pr1``, the goal-MPC
planner in solver and in net mode with ``goal_mpc_pr``):

- the synchronised host time of a control step, split into observe, plan
  and env step (medians over ``--steps`` steps after ``--warmup``);
- under ``torch.profiler``, the unsynchronised time per step, the device
  time per step, the device's idle share and the kernel launches per step;

for one reference lattice family (2,642,368 goals, 600 sweeps, the table
generator's chunks) the wall time, the device time and the ADMM kernel's
share of it; and for the fit-and-train path on that family's table
(``goal_mpc_pr``'s shape: R=16, K=512, F=5, O=2):

- a train step of the L1 loss at batch 8192 through ``train_epochs``: ms
  per step, device ms per step, idle share, launches per step, and the
  device time by kernel;
- one region's gram pass of ``fit_per_region``: the same, per chunk.

``--parts worlds`` profiles the same way the loops of the map world and
the bank: the 12-arm grip-adaptive bank, the cartesian planner, and the
Frenet planner in the oval's rasterized map with scans and iTTC (observe
then includes the scan).

``--parts nmpc`` profiles the batched NMPC solver instead (f32, rows drawn
by seed from the flagship table's ranges), at ``--nmpc_batches`` rows (1,000
and the table generator's chunk by default): one default solve's seconds,
Newton iterations and seconds per iteration; under ``torch.profiler`` a
short solve's kernel launches per iteration, device time, idle share and top
device operations; and the synchronised split of one iteration into the
fused derivative pass, the SPD solve and the line search.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from irbfn_tpu_torch.dynamics import VehicleParams, f1tenth_params
from irbfn_tpu_torch.parallel import gen_goal_mpc_table as gen
from irbfn_tpu_torch.parallel.gen_nmpc_table_frenet import wide_rows
from irbfn_tpu_torch.planning import GoalMPCPlanner, IRBFNFrenetPlanner
from irbfn_tpu_torch.sim import TrackEnv, oval_track
from irbfn_tpu_torch.models import build_region_bounds
from irbfn_tpu_torch.models.fit import device_table, fit_per_region
from irbfn_tpu_torch.train import (create_trainer, input_bounds_from_config,
                                   load_model, make_train_step, pred_l1_loss,
                                   train_epochs)

ASSETS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "assets")


def load_lanes() -> dict:
    """The eval sweep's lanes as the goldens store them: ``loop_mu``,
    ``loop_cs`` (10x10 (mu, cs) x 10 trials = 1000 lanes) and
    ``loop_noise`` (unit-normal start-pose draws)."""
    with np.load(os.path.join(ASSETS, "goal_mpc_golden.npz")) as z:
        return {k: z[k] for k in ("loop_mu", "loop_cs", "loop_noise")}


def sweep_env(device, control_mode, lanes, speed_scale=1.0, **env_kw):
    """The eval sweep on the oval track: per-lane (mu, cs) vehicles, start
    noise 0.01 * ``loop_noise``, a 2 m corridor (``env_kw`` override the
    env's arguments; ``speed_scale`` scales the raceline's speed, as the
    eval script's flag does). Returns (env, sim0)."""
    mu = torch.as_tensor(lanes["loop_mu"], device=device)
    cs = torch.as_tensor(lanes["loop_cs"], device=device)
    B = mu.numel()
    base = f1tenth_params(device=device)
    lane = {f: getattr(base, f).expand(B).contiguous()
            for f in ("m", "I", "lf", "lr", "h", "sv_max", "a_max", "s_max",
                      "v_max")}
    params = VehicleParams(mu=mu, C_Sf=cs, C_Sr=cs,
                           dt=torch.full((B,), 0.01, device=device), **lane)
    track = oval_track(30.0, 15.0, n_samples=512, speed=3.0, device=device)
    if speed_scale != 1.0:
        rl = track.raceline
        track = track._replace(raceline=rl._replace(vxs=rl.vxs * speed_scale))
    env = TrackEnv(track, params, control_mode=control_mode,
                   **{"half_width": 2.0, **env_kw})
    sim = env.reset(s0=0.0, speed0=1.0, batch_shape=(B,), noise_scale=0.01,
                    noise=torch.as_tensor(lanes["loop_noise"],
                                          device=device))
    return env, sim


def policies(device):
    """{name: (control mode, policy)} of the three closed loops."""
    frenet, config = load_model(os.path.join(ASSETS, "frenet_wide_pr1.json"),
                                os.path.join(ASSETS, "frenet_wide_pr1.npz"),
                                device=device)
    goal_net, _ = load_model(os.path.join(ASSETS, "goal_mpc_pr.json"),
                             os.path.join(ASSETS, "goal_mpc_pr.npz"),
                             device=device)
    track = oval_track(30.0, 15.0, n_samples=512, speed=3.0, device=device)
    fp = IRBFNFrenetPlanner(frenet, track,
                            input_bounds=input_bounds_from_config(config))

    def frenet_policy(obs):
        r = fp.plan_batch(obs.s, obs.ey, obs.epsi, obs.delta,
                          obs.linear_vel_x, obs.linear_vel_y, obs.ang_vel_z)
        return torch.stack([r.accel, r.steer_vel], dim=-1)

    def goal_policy(planner):
        return lambda obs: torch.stack(planner.plan_batch(
            obs.pose_x, obs.pose_y, obs.pose_theta, obs.linear_vel_x), dim=-1)

    return {"frenet": ("accl", frenet_policy),
            "goal solver": ("speed", goal_policy(GoalMPCPlanner(track))),
            "goal net": ("speed", goal_policy(GoalMPCPlanner(track,
                                                             goal_net)))}


BANK_MUS = (0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8, 0.9, 1.0, 1.1, 1.2)


def world_loops(device, lanes):
    """{name: (env, sim0, policy)} of the loops of the map world and the
    bank: the 12-arm grip-adaptive bank (``--pace_lo 0.2``, raceline speed
    x2.5), the cartesian planner (``cart_c1_pr``), and the flagship in the
    oval's rasterized map with 64-beam scans, iTTC and a 0.15 m disc. A
    stateful policy carries its state in a closure."""
    from irbfn_tpu_torch.planning import (GripAdaptiveFrenetPlanner,
                                          IRBFNPlanner)
    from irbfn_tpu_torch.sim import ScanSpec, rasterize_track

    def asset(run):
        net, conf = load_model(os.path.join(ASSETS, f"{run}.json"),
                               os.path.join(ASSETS, f"{run}.npz"),
                               device=device)
        return net.eval(), conf

    arms = [asset(f"bank6_pr_mu{m:.2f}") for m in BANK_MUS]
    env_b, sim_b = sweep_env(device, "accl", lanes, speed_scale=2.5)
    bank = GripAdaptiveFrenetPlanner(
        arms[0][0], [a[0] for a in arms], BANK_MUS, env_b.track,
        input_bounds=input_bounds_from_config(arms[0][1]), pace_lo=0.2)
    state = [bank.init_state((sim_b.s.numel(),))]
    step = bank.policy()

    def bank_policy(obs):
        action, state[0] = step(state[0], obs)
        return action

    cart, conf = asset("cart_c1_pr")
    env_c, sim_c = sweep_env(device, "accl", lanes)
    cp = IRBFNPlanner(cart, env_c.track, mirror=bool(conf.get("mirror", True)),
                      sv_ind=int(conf["out_features"]) // 2,
                      input_bounds=input_bounds_from_config(conf))

    def cart_policy(obs):
        r = cp.plan_batch(obs.pose_x, obs.pose_y, obs.pose_theta, obs.delta,
                          obs.linear_vel_x, obs.beta, obs.ang_vel_z)
        return torch.stack([r.accel, r.steer_vel], dim=-1)

    flagship, conf = asset("frenet_wide_pr1")
    track = oval_track(30.0, 15.0, n_samples=512, speed=3.0, device=device)
    env_m, sim_m = sweep_env(device, "accl", lanes, half_width=None,
                             occ_map=rasterize_track(track, half_width=2.0),
                             car_radius=0.15, scan_spec=ScanSpec(),
                             enable_ttc=True)
    fp = IRBFNFrenetPlanner(flagship, env_m.track,
                            input_bounds=input_bounds_from_config(conf))

    def map_policy(obs):
        r = fp.plan_batch(obs.s, obs.ey, obs.epsi, obs.delta,
                          obs.linear_vel_x, obs.linear_vel_y, obs.ang_vel_z)
        return torch.stack([r.accel, r.steer_vel], dim=-1)

    return {"grip-adaptive bank (12 arms)": (env_b, sim_b, bank_policy),
            "cartesian": (env_c, sim_c, cart_policy),
            "Frenet in the map world (scans, iTTC)": (env_m, sim_m,
                                                      map_policy)}


def _kernels(prof) -> list:
    """The profile's device-side rows (kernels and device copies). The
    host-side operator rows carry their kernels' device time a second time:
    summing every row would count it twice."""
    return [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]


def _device_ms(prof) -> float:
    return sum(e.self_device_time_total for e in _kernels(prof)) / 1e3


def profile_loop(env, sim, policy, steps, warmup):
    split = {"observe": [], "plan": [], "step": []}
    for i in range(warmup + steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        obs = env.observe(sim)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        action = policy(obs)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        sim = env.step(sim, action, obs.scan)
        torch.cuda.synchronize()
        if i >= warmup:
            split["observe"].append(t1 - t0)
            split["plan"].append(t2 - t1)
            split["step"].append(time.perf_counter() - t2)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            obs = env.observe(sim)
            sim = env.step(sim, policy(obs), obs.scan)
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0)
    launches = sum(e.count for e in prof.key_averages()
                   if e.key == "cudaLaunchKernel")
    dev = _device_ms(prof)
    return ({k: 1e3 * float(np.median(v)) for k, v in split.items()},
            wall / steps, dev / steps, 1.0 - dev / wall, launches / steps)


def profile_family(device):
    args = gen.parse_args(["--device", str(device), "--v_car_min", "8.0"])
    gen.solve_table(args)  # warm: builds, handles, pinned buffers
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        res = gen.solve_table(args)
        torch.cuda.synchronize()
    kernel = sum(e.self_device_time_total for e in _kernels(prof)
                 if "admm_solve_kernel" in e.key) / 1e3
    return 1e3 * res["seconds"], _device_ms(prof), kernel, res


def _top_device(prof, n=8) -> str:
    """The ``n`` kernels with the most device time, as 'name share'."""
    rows = sorted(_kernels(prof), key=lambda e: -e.self_device_time_total)
    total = sum(e.self_device_time_total for e in rows) or 1
    return ", ".join(
        f"{e.key[:60]} x{e.count} "
        f"{100 * e.self_device_time_total / total:.0f}%" for e in rows[:n])


def _profiled(fn, units: int):
    """``fn()`` once warm, then under the profiler: (wall ms, device ms,
    idle share, launches) per unit, and the top operators."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0)
    launches = sum(e.count for e in prof.key_averages()
                   if e.key == "cudaLaunchKernel")
    dev = _device_ms(prof)
    return (wall / units, dev / units, 1.0 - dev / wall, launches / units,
            _top_device(prof))


def profile_fit_and_train(device, family, steps, batch=8192):
    """A train step and a gram pass at ``goal_mpc_pr``'s shape on one
    family's table."""
    table = gen.table_arrays(family)
    inputs = table["inputs"][table["valid"]]
    outputs = table["outputs"][table["valid"]]
    net, config = load_model(os.path.join(ASSETS, "goal_mpc_pr.json"),
                             os.path.join(ASSETS, "goal_mpc_pr.npz"),
                             device=device)
    x_dev, y_dev, n = device_table(inputs, outputs, device=device)
    rows = steps * batch
    trainer = create_trainer(net, lr=1e-6)
    step_fn = make_train_step(pred_l1_loss, None)
    train = _profiled(lambda: train_epochs(
        trainer, step_fn, x_dev[:rows], y_dev[:rows], batch_size=batch,
        epochs=1, seed=0), steps)
    lb, ub = build_region_bounds(config["lower_bounds"],
                                 config["upper_bounds"],
                                 config["dimension_ranges"],
                                 config["activation_idx"])
    timings = {}

    r = slice(len(lb) - 1, len(lb))  # the last region: its box holds v_car = 8

    def one_region():  # one region's box, in chunks of 65,536 rows
        timings.clear()
        fit_per_region(inputs, outputs, net.centers.detach()[r],
                       net.log_sigs.detach()[r], lb[r], ub[r],
                       config["delta"], tuple(config["activation_idx"]),
                       config["basis_func"],
                       input_scale=tuple(config["input_scale"]),
                       x_dev=x_dev, y_dev=y_dev, timings=timings)

    one_region()
    chunks = -(-timings["row_visits"] // 65536)
    return train, _profiled(one_region, chunks), timings["row_visits"]


def profile_nmpc(device, batch: int, seed: int = 0):
    """One default f32 solve of ``batch`` wide-range rows, a short solve
    under the profiler, and one Newton iteration's parts."""
    import dataclasses

    from irbfn_tpu_torch.dynamics import fullscale_params
    from irbfn_tpu_torch.solvers import nmpc

    rows = torch.as_tensor(wide_rows(batch, seed), device=device)
    params = fullscale_params(device=device)
    cfg = nmpc.NMPCConfig()
    short = dataclasses.replace(cfg, gn_iters=3, al_outer=1)
    nmpc.solve_lattice_point(rows, params, short)  # warm
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    sol = nmpc.solve_lattice_point(rows, params, cfg)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    iters = nmpc.LAST_SOLVE_STATS["newton_iterations"]
    peak = torch.cuda.max_memory_allocated() / 2**30
    feasible = float(sol.feasible.float().mean())
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        nmpc.solve_lattice_point(rows, params, short)
        torch.cuda.synchronize()
        p_wall = 1e3 * (time.perf_counter() - t0)
    p_iters = nmpc.LAST_SOLVE_STATS["newton_iterations"]
    launches = sum(e.count for e in prof.key_averages()
                   if e.key == "cudaLaunchKernel")
    dev = _device_ms(prof)

    # one iteration's parts, synchronised, at the cold start u = 0
    T = cfg.horizon
    zeros = torch.zeros_like(rows[:, 0])
    x0 = torch.stack([zeros, rows[:, 0], rows[:, 1], rows[:, 2], rows[:, 3],
                      rows[:, 5], rows[:, 6]], dim=-1)
    goal = torch.zeros_like(x0)
    goal[:, 3] = rows[:, 4]
    curv = rows[:, 7].contiguous()
    u = torch.zeros((batch, 2 * T), device=device)
    lam = torch.zeros((batch, 4 * (T + 1)), device=device)
    rho = torch.tensor(cfg.penalty0, device=device)
    lo, hi = nmpc._control_bounds(cfg, torch.float32, device)
    lo_flat, hi_flat = lo.repeat(T), hi.repeat(T)
    p_c = nmpc._lift_params(params, 1)

    def obj_cands(c):
        lead = c.shape[:2]
        return nmpc._objective_and_states(
            c, x0[:, None].expand(lead + (7,)),
            goal[:, None].expand(lead + (7,)), curv[:, None].expand(lead),
            lam[:, None], rho, p_c, cfg)

    def timed(fn, reps=3):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            out = fn()
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t0) / reps, out

    with torch.no_grad():
        t_deriv, (H_s, Jw, v, gs, w) = timed(lambda: nmpc._fused_derivatives(
            u, x0, goal, curv, lam, rho, params, cfg))
        JwT = Jw.transpose(-1, -2)
        g = gs + 2.0 * (JwT @ w[..., None])[..., 0]
        A = (H_s + 2.0 * (JwT @ Jw)
             + 1e-4 * torch.eye(2 * T, device=device))
        t_spd, step = timed(lambda: nmpc._solve_spd(A, g))
        t_ls, _ = timed(lambda: nmpc._line_search(
            u, step, obj_cands, lo_flat, hi_flat, cfg))
    return dict(batch=batch, wall=wall, iters=iters, feasible=feasible,
                peak_gib=peak, p_wall_ms=p_wall, p_iters=p_iters,
                launches=launches, device_ms=dev, top=_top_device(prof, 6),
                t_deriv=t_deriv, t_spd=t_spd, t_ls=t_ls)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--steps", type=int, default=30)
    p.add_argument("--warmup", type=int, default=20)
    p.add_argument("--parts", type=str, default="loops,fit",
                   help="what to profile: the closed loops, the loops of "
                        "the map world and the bank (worlds), the lattice "
                        "family with the fit and train step on its table, "
                        "the NMPC solver")
    p.add_argument("--nmpc_batches", type=str, default="1000,65536",
                   help="rows per solve for --parts nmpc")
    args = p.parse_args(argv)
    parts = set(args.parts.split(","))
    if not parts <= {"loops", "worlds", "fit", "nmpc"}:
        p.error("--parts takes loops, worlds, fit and nmpc, not "
                f"{args.parts!r}")
    device = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "-i", "0",
                          "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip() or torch.cuda.get_device_name(0), flush=True)
    for batch in ([int(b) for b in args.nmpc_batches.split(",")]
                  if "nmpc" in parts else ()):
        r = profile_nmpc(device, batch)
        per_it = r["wall"] / max(r["iters"], 1)
        print(f"NMPC solve, f32, B={batch:,} wide-range rows, default "
              f"budgets: {r['wall']:.2f} s, {r['iters']} Newton iterations, "
              f"{1e3 * per_it:.1f} ms per iteration, "
              f"{batch / r['wall']:,.0f} solves/s, feasible "
              f"{100 * r['feasible']:.1f}%, peak memory {r['peak_gib']:.2f} "
              f"GiB; a {r['p_iters']}-iteration solve under the profiler: "
              f"{r['p_wall_ms']:.1f} ms, device {r['device_ms']:.1f} ms, idle "
              f"share {1 - r['device_ms'] / r['p_wall_ms']:.3f}, "
              f"{r['launches'] / r['p_iters']:.0f} kernel launches per "
              f"iteration (the solve's set-up and diagnostics included); one "
              f"iteration's parts, synchronised: fused derivative pass "
              f"{r['t_deriv']:.1f} ms, SPD solve {r['t_spd']:.2f} ms, line "
              f"search {r['t_ls']:.1f} ms; device time by kernel: {r['top']}",
              flush=True)
    lanes = load_lanes()
    loops = {}
    if "loops" in parts:
        loops.update({name: sweep_env(device, mode, lanes) + (policy,)
                      for name, (mode, policy) in policies(device).items()})
    if "worlds" in parts:
        loops.update(world_loops(device, lanes))
    for name, (env, sim, policy) in loops.items():
        split, wall, dev, idle, launches = profile_loop(
            env, sim, policy, args.steps, args.warmup)
        print(f"{name} loop, 1000 lanes: synchronised ms per step "
              + ", ".join(f"{k} {v:.3f}" for k, v in split.items())
              + f"; under the profiler {wall:.2f} ms per step, device "
              f"{dev:.3f} ms per step, idle share {idle:.3f}, "
              f"{launches:.0f} kernel launches per step", flush=True)
    if "fit" not in parts:
        return
    wall, dev, kernel, family = profile_family(device)
    print(f"one lattice family under the profiler: wall {wall:.1f} ms, "
          f"device {dev:.1f} ms, admm_solve kernel {kernel:.1f} ms "
          f"({100 * kernel / dev:.1f}% of device time), idle share "
          f"{1 - dev / wall:.3f}", flush=True)
    train, gram, visits = profile_fit_and_train(device, family, args.steps)
    for name, (wall, dev, idle, launches, top) in (
            ("train step (L1 loss, batch 8192, R=16, K=512, F=5)", train),
            (f"fit of one region ({visits:,} rows: box test, gram pass, "
             "solve), per chunk of 65,536", gram)):
        print(f"{name} under the profiler: {wall:.3f} ms, device {dev:.3f} "
              f"ms, idle share {idle:.3f}, {launches:.0f} kernel launches; "
              f"device time by kernel: {top}", flush=True)


if __name__ == "__main__":
    main()
