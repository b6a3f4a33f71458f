"""Where the port's paths spend their time on the card.

``python -m irbfn_tpu_torch.utils.profiling [--steps 30] [--warmup 20]``
runs on one CUDA card and prints, for each closed loop at the eval sweep's
1000 lanes (the Frenet planner with ``frenet_wide_pr1``, the goal-MPC
planner in solver and in net mode with ``goal_mpc_pr``):

- the synchronised host time of a control step, split into observe, plan
  and env step (medians over ``--steps`` steps after ``--warmup``);
- under ``torch.profiler``, the unsynchronised time per step, the device
  time per step, the device's idle share and the kernel launches per step;

and for one reference lattice family (2,642,368 goals, 600 sweeps, the
table generator's chunks) the wall time, the device time and the ADMM
kernel's share of it.
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
from irbfn_tpu_torch.planning import GoalMPCPlanner, IRBFNFrenetPlanner
from irbfn_tpu_torch.sim import TrackEnv, oval_track
from irbfn_tpu_torch.train import input_bounds_from_config, load_model

ASSETS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "assets")


def load_lanes() -> dict:
    """The eval sweep's lanes as the goldens store them: ``loop_mu``,
    ``loop_cs`` (10x10 (mu, cs) x 10 trials = 1000 lanes) and
    ``loop_noise`` (unit-normal start-pose draws)."""
    with np.load(os.path.join(ASSETS, "goal_mpc_golden.npz")) as z:
        return {k: z[k] for k in ("loop_mu", "loop_cs", "loop_noise")}


def sweep_env(device, control_mode, lanes):
    """The eval sweep on the oval track: per-lane (mu, cs) vehicles, start
    noise 0.01 * ``loop_noise``, a 2 m corridor. Returns (env, sim0)."""
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
    env = TrackEnv(track, params, half_width=2.0, control_mode=control_mode)
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


def _device_ms(prof) -> float:
    return sum(e.self_device_time_total for e in prof.key_averages()) / 1e3


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
        sim = env.step(sim, action)
        torch.cuda.synchronize()
        if i >= warmup:
            split["observe"].append(t1 - t0)
            split["plan"].append(t2 - t1)
            split["step"].append(time.perf_counter() - t2)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            sim = env.step(sim, policy(env.observe(sim)))
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
    kernel = sum(e.self_device_time_total for e in prof.key_averages()
                 if "admm_solve_kernel" in e.key) / 1e3
    return 1e3 * res["seconds"], _device_ms(prof), kernel


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--steps", type=int, default=30)
    p.add_argument("--warmup", type=int, default=20)
    args = p.parse_args(argv)
    device = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "-i", "0",
                          "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip() or torch.cuda.get_device_name(0), flush=True)
    lanes = load_lanes()
    for name, (mode, policy) in policies(device).items():
        env, sim = sweep_env(device, mode, lanes)
        split, wall, dev, idle, launches = profile_loop(
            env, sim, policy, args.steps, args.warmup)
        print(f"{name} loop, 1000 lanes: synchronised ms per step "
              + ", ".join(f"{k} {v:.3f}" for k, v in split.items())
              + f"; under the profiler {wall:.2f} ms per step, device "
              f"{dev:.3f} ms per step, idle share {idle:.3f}, "
              f"{launches:.0f} kernel launches per step", flush=True)
    wall, dev, kernel = profile_family(device)
    print(f"one lattice family under the profiler: wall {wall:.1f} ms, "
          f"device {dev:.1f} ms, admm_solve kernel {kernel:.1f} ms "
          f"({100 * kernel / dev:.1f}% of device time), idle share "
          f"{1 - dev / wall:.3f}", flush=True)


if __name__ == "__main__":
    main()
