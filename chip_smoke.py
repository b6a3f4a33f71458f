#!/usr/bin/env python3
"""On-card smoke run of the PyTorch port (one NVIDIA GPU).

Drives ``irbfn_tpu_torch`` through its two paths, each with its hand-written
kernel: the learned Frenet planner in closed loop, with the flagship
``frenet_wide_pr1`` WCRBF net (R=16 regions, K=512 kernels, F=8 inputs,
O=10 outputs, per-region heads; kernel ``rbf_forward``), and the goal-MPC
path (kernel ``admm_solve``): the reference goal lattice and the goal-MPC
closed loop in both planner modes, the live ADMM solve and the
``goal_mpc_pr`` net (F=5, O=2). Each phase prints one line, and any failure
exits non-zero:

1. device: requires CUDA (never falls back to the CPU); prints the card's
   name and power limit as nvidia-smi reports them;
2. build: compiles both ``irbfn_tpu_torch/ops/csrc/*.cu`` into ``build/``
   with nvcc, one process each, started together;
3. RBF kernel vs its plain PyTorch version on the card: the flagship at
   B in {1, 7, 1000, 1024}, around the kernel's 32-row batch tile (31, 32,
   33) and at 4096, a shared-head net of the same width, every basis
   function at a small shape, shapes off the kernel's tiles (K = 100, O = 17,
   F = 16, R = 1 and 5), the distance-cancellation regime, and two
   forwards of one input, which must agree bit for bit;
4. against JAX: the forward and ``IRBFNFrenetPlanner.plan_batch`` against
   the goldens the JAX package wrote (``scripts/export_torch_ckpt.py``);
5. Frenet closed loop: the eval sweep's defaults, 10x10 (mu, cs) x 10
   trials = 1000 lanes x 600 control steps on the oval track, with the
   kernels' launches counted; completions and mean |ey| against the golden;
6. times: the batch-1024 flagship forward, kernel against plain version;
7. ADMM kernel vs its plain version: one-family launches at v_car in
   {-1, 4.5, 8} x G in {1, 7, 96, 4097} at 300 and 600 sweeps, two whole
   reference families (2,642,368 goals each) row by row, the planner's
   shape (1000 one-goal families), shapes on both sides of the rule that
   picks the kernel's variant, and two solves of one input, bit for bit;
8. the RBF kernel at the goal net's width against its plain version and the
   golden's f64 forward;
9. goal-MPC against JAX: 4,864 golden lattice rows through the kernel
   against JAX's f64 and f32 solves, and both planner modes' ``plan_batch``;
10. the whole reference lattice, 50,204,992 QPs at 600 sweeps, through the
    table generator's solve: QP solves/s, share converged, launches;
11. goal-MPC closed loop, solver mode (the ADMM kernel): 1000 lanes x 600
    steps in the speed action mode against the JAX golden, launches
    counted;
12. the same in net mode (the RBF kernel);
13. times with CUDA events, kernel and plain version in turns: the ADMM
    solve of one whole family (in one launch, and as the table generator's
    11 chunks of 262,144) and of 1000 one-goal families, the ``goal_mpc_pr``
    forward at B=1024, the flagship forward at B=1, and an empty launch.

The last two lines are a JSON object naming both kernels with their
launches, errors, times and bounds, and the line
``{"ok": true, "device": {...}}``.

Usage, from the repository root: ``python3 chip_smoke.py``
"""

import json
import os
import re
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
ASSETS = os.path.join(ROOT, "irbfn_tpu_torch", "assets")
ASSET = os.path.join(ASSETS, "frenet_wide_pr1")
GOAL_ASSET = os.path.join(ASSETS, "goal_mpc_pr")
GOAL_GOLDEN = os.path.join(ASSETS, "goal_mpc_golden.npz")
KERNELS = {
    "rbf_forward": {"name": "rbf_forward", "route": "cuda",
                    "source": "irbfn_tpu_torch/ops/csrc/rbf_forward.cu",
                    "replaces": "irbfn_tpu/ops/pallas_rbf.py:45"},
    "admm_solve": {"name": "admm_solve", "route": "cuda",
                   "source": "irbfn_tpu_torch/ops/csrc/admm_solve.cu",
                   "replaces": "irbfn_tpu/ops/pallas_admm.py:56"},
}
# one H100 SXM's published peaks: f32 outside the tensor cores, HBM3
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
N_STEPS = 600  # control steps of every closed loop
# the lattice generator's flags (its defaults: the whole reference lattice)
LATTICE_ARGS = ()

# Tolerances, with their reasons:
# - the flagship head is ill-conditioned (sum |w| ~ 2e5 per output): an f32
#   forward differs from f64 by up to ~4e-4 whatever the summation order, so
#   two f32 paths, or an f32 path and the f64 JAX golden, agree to ~1e-3;
TOL_FLAGSHIP = 1e-3
# - well-conditioned random nets: f32 summation-order noise, relative to
#   the output's magnitude;
TOL_RANDOM = 1e-4
# - the closed loop is held against the JAX golden lane by lane. The same
#   lanes must finish (none leaves the 2 m corridor, by a wide margin). f32
#   differences grow along 600 steps of feedback in a few lanes: the port's
#   plain version on a CPU differed from the golden by 2 um median, 1.2 mm at
#   the 99th percentile and 3.2 mm at most in per-lane mean |ey|, by 1.5 m
#   at most in final progress, and by 0.001 mm in the sweep's mean |ey|.
#   Final progress sits within 1 cm of the second lap's line in the slowest
#   lane, so a lap count may flip there.
TOL_EY_LANE_MM = 10.0  # per-lane mean |ey|
TOL_EY_SWEEP_MM = 0.1  # mean |ey| over the 1000 lanes
TOL_LAP_LANES = 10  # lanes whose lap count may differ, by one lap
# - the ADMM kernel against its plain version, and the port against JAX's
#   f32 solve: the limits of tests/test_goal_mpc.py::
#   test_pallas_admm_matches_xla_loop (steer 1e-5, r_prim 5e-5, converged
#   flags identical), except the full control plan and with it the speed.
#   Two f32 ADMM paths differ in the plan by their products' summation
#   order, grown over the sweeps, and each is up to ~2.5e-4 from the f64
#   solution: phase 9 prints JAX's own f32 loop and the kernel against
#   JAX's f64 solve on the golden's 4,864 lattice rows (on a CPU, JAX's f32
#   loop and the port's plain version were 2.4e-4 from it), phase 7 the
#   plain f32 version against f64 arithmetic on a whole family. So two f32
#   plans agree to twice that, and speeds (v_car + dt a_0) to dt times it.
TOL_CONTROLS = 5e-4
TOL_SPEED = 0.05 * TOL_CONTROLS
TOL_STEER = 1e-5
TOL_RPRIM = 5e-5
# - converged flags (both residuals under 2e-3): identical, except in rows
#   whose plain-version residual lies within TOL_RES_BAND of 2e-3, where f32
#   noise decides. The residuals of two f32 paths differed by up to 8.0e-5
#   (r_dual, kernel vs plain, 4,097 goals at v_car = 8 on an H100 80GB HBM3,
#   700 W; port vs JAX f32 on a CPU: 7.9e-5), and at 300 sweeps ~7% of the
#   v_car = 8 rows are still near the limit: one of 4,097 flipped there.
TOL_RES_BAND = 2e-4
# - the f32 solve against JAX's f64 one: tests/test_goal_mpc.py::
#   test_goal_mpc_f32_close_to_f64;
TOL_F64 = 3e-3
# - the goal net (sum |w| ~ 6.5e3 per output) and both planner modes in f32
#   against JAX's f64: the port's plain f32 versions on a CPU were 1.5e-5
#   (forward) and 1.1e-5 (plan_batch) from the f64 goldens;
TOL_GOAL_NET = 1e-4
# - the goal-MPC closed loops against their JAX goldens. The PID steers
#   bang-bang at sv_max outside a 1e-4 steer deadband, so a small difference
#   in a planned steer can flip a substep's steering rate, and lanes spread
#   far more than in the accl loop. The port's plain versions on a CPU
#   (solver mode / net mode) differed from the goldens in per-lane mean |ey|
#   by 0.006 / 0.64 mm median, 22 / 41 mm at the 99th percentile and 45 /
#   61 mm at most, in the sweep's mean |ey| by 0.11 / 0.06 mm, and in final
#   progress by 2.0 / 3.0 m at most; every lane finished as in JAX, with the
#   same laps (two), none within 1 m of a lap line.
TOL_GOAL_EY_MEDIAN_MM = 5.0  # median over lanes of the per-lane difference
TOL_GOAL_EY_LANE_MM = 150.0  # any lane
TOL_GOAL_EY_SWEEP_MM = 0.5  # mean |ey| over the 1000 lanes
TOL_GOAL_LAP_LANES = 10


class SmokeFailure(RuntimeError):
    pass


def check(ok: bool, msg: str):
    if not ok:
        raise SmokeFailure(msg)


def phase_device():
    import torch

    smi = subprocess.run(["nvidia-smi", "-i", "0",
                          "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    print(smi.stdout.strip(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda:0")


def ptxas_summary(log: str) -> str:
    """``ptxas -v``'s registers and spills, one entry per kernel of the
    library: ``name<template arguments>: registers, spilled bytes``."""
    out, name = [], "?"
    spill = ""
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:  # _ZN..._GLOBAL__N__...<len>name<args>...: keep name and args
            name = m.group(1)
            k = re.search(r"\d+((?:rbf|admm)\w*?kernel\w*?)I(\w+?)EEv", name)
            name = (f"{k.group(1)}<"
                    f"{', '.join(re.findall(r'Li(\d+)E', k.group(2)))}>"
                    if k else re.sub(r"^.*?\d+((?:rbf|admm)_[a-z_]*kernel)E.*",
                                     r"\1", name))
        elif "spill" in line:
            s = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", line)
            spill = f"spills {s.group(1)}+{s.group(2)} B" if s else line
        elif "registers" in line:
            r = re.search(r"Used (\d+) registers", line)
            out.append(f"{name}: {r.group(1) if r else '?'} registers, "
                       f"{spill}")
    return "; ".join(out)


def phase_build():
    """Both kernels' nvcc processes, started together; registers and spills
    of every kernel, which must be none."""
    from irbfn_tpu_torch.ops import KERNELS as OPS, build_kernel

    with ThreadPoolExecutor(len(OPS)) as pool:
        results = dict(zip(OPS, pool.map(build_kernel, OPS)))
    for name, res in results.items():
        print(f"build {name}: {res.path.name} in {res.seconds:.2f} s nvcc"
              f"{' (already built)' if res.seconds == 0.0 else ''}; "
              f"{ptxas_summary(res.log)}", flush=True)
        spilled = [int(n) for n in re.findall(r"(\d+) bytes spill", res.log)]
        check(not any(spilled), f"{name} spills registers: {res.log}")


def reset_launches():
    from irbfn_tpu_torch.ops import admm_solve, wcrbf_forward

    admm_solve.launches = 0
    wcrbf_forward.launches = 0


def read_launches() -> dict:
    from irbfn_tpu_torch.ops import admm_solve, wcrbf_forward

    return {"rbf_forward": wcrbf_forward.launches,
            "admm_solve": admm_solve.launches}


def _flagship(device):
    import torch

    from irbfn_tpu_torch.train import load_model

    model, config = load_model(ASSET + ".json", ASSET + ".npz",
                               device=device, dtype=torch.float32)
    return model.eval(), config


def _max_err(a, b) -> float:
    return float((a.double() - b.double()).abs().max())


def _compare(label, x, ops, tol, relative=False):
    """Kernel vs the plain version on the same card tensors; ``relative``
    divides the error by max(1, max|plain|)."""
    import torch

    from irbfn_tpu_torch.ops import rbf

    with torch.no_grad():
        ref = rbf.wcrbf_forward_reference(x, ops)
        got = rbf.wcrbf_forward(x, ops)
    torch.cuda.synchronize()
    err = _max_err(got, ref)
    if relative:
        err /= max(1.0, float(ref.abs().max()))
    check(bool(torch.isfinite(got).all()) and err <= tol,
          f"{label}: kernel vs plain {'rel ' if relative else ''}max|err| "
          f"{err:.3e} > {tol:.1e}")
    return err


def _random_net(rng, device, R, K, F, O, basis, head_mode):
    """A WCRBFNet with numpy-drawn weights and an anisotropic input scale;
    its R <= 2**n regions are the first R boxes of the first n even dims
    split at 0."""
    import torch

    from irbfn_tpu_torch.models import WCRBFNet

    n = (R - 1).bit_length()
    act = [2 * i for i in range(n)]
    ranges = [[(r >> i) & 1 for i in range(n)] for r in range(R)]
    model = WCRBFNet(F, O, K, basis, R, [[-3.0, 0.0]] * n, [[0.0, 3.0]] * n,
                     ranges, act, [10.0] * n,
                     input_scale=tuple(rng.uniform(0.5, 2.0, F)),
                     head_mode=head_mode, device=device)
    n_feat = model.head_kernel.shape[0]
    state = {"centers": rng.normal(0.0, 1.5, (R, K, F)),
             "log_sigs": rng.uniform(-0.5, 0.5, (R, K)),
             "head_kernel": rng.normal(0.0, n_feat ** -0.5, (n_feat, O)),
             "head_bias": rng.normal(0.0, 0.1, (O,))}
    model.load_state_dict({k: torch.tensor(v, dtype=torch.float32)
                           for k, v in state.items()})
    return model.eval()


def _random_x(rng, net, B, device):
    import torch

    x = torch.as_tensor(rng.normal(0.0, 1.5, (B, net.in_features)),
                        dtype=torch.float32, device=device)
    return (x * net.input_scale).contiguous()


def phase_kernel_vs_plain(device, golden):
    import torch

    from irbfn_tpu_torch.models import BASIS_FUNCTIONS
    from irbfn_tpu_torch.ops import wcrbf_forward, wcrbf_params_to_kernel

    rng = np.random.default_rng(0)
    model, config = _flagship(device)
    ops = wcrbf_params_to_kernel(model)
    x = torch.as_tensor(golden["x"], device=device) * model.input_scale
    errs = {}
    for B in (1, 7, 31, 32, 33, 1000, 1024):
        errs[B] = _compare(f"flagship B={B}", x[:B].contiguous(), ops,
                           TOL_FLAGSHIP)
    errs[4096] = _compare("flagship B=4096", x.repeat(4, 1), ops,
                          TOL_FLAGSHIP)
    with torch.no_grad():  # the same bits on every call
        twice = [wcrbf_forward(x, ops) for _ in range(2)]
    check(torch.equal(*twice), "two flagship forwards of one input differ")
    shared = _random_net(rng, device, 16, 512, 8, 10, "gaussian", "shared")
    e_shared = _compare("shared head R=16 K=512",
                        _random_x(rng, shared, 1024, device),
                        wcrbf_params_to_kernel(shared), TOL_RANDOM,
                        relative=True)
    e_basis = 0.0  # every basis, both head modes, a ragged batch of 65
    for name in BASIS_FUNCTIONS:
        for mode in ("shared", "per_region"):
            net = _random_net(rng, device, 4, 32, 8, 10, name, mode)
            e_basis = max(e_basis, _compare(
                f"basis {name} {mode}", _random_x(rng, net, 65, device),
                wcrbf_params_to_kernel(net), TOL_RANDOM, relative=True))
    # off the kernel's tiles: K no multiple of 32, O over one output chunk,
    # F over 8, one region, and a region count no group size divides
    e_shapes = {}
    for R, K, F, O, B in ((4, 100, 8, 10, 65), (4, 64, 8, 17, 65),
                          (4, 64, 16, 10, 65), (1, 128, 8, 3, 65),
                          (5, 100, 5, 17, 4096), (5, 64, 12, 2, 300)):
        for mode in ("shared", "per_region"):
            net = _random_net(rng, device, R, K, F, O, "gaussian", mode)
            e = _compare(f"R={R} K={K} F={F} O={O} B={B} {mode}",
                         _random_x(rng, net, B, device),
                         wcrbf_params_to_kernel(net), TOL_RANDOM,
                         relative=True)
            e_shapes[R, K, F, O, B] = max(e, e_shapes.get((R, K, F, O, B),
                                                          0.0))
    e_cancel = phase_cancellation(device)
    print("kernel vs plain: flagship max|err| "
          + ", ".join(f"B={b} {e:.2e}" for b, e in errs.items())
          + f" (tol {TOL_FLAGSHIP}), two forwards bitwise equal; shared head "
          f"R=16 K=512 rel {e_shared:.2e}; 15 bases x 2 heads rel "
          f"{e_basis:.2e}; (R, K, F, O, B) x 2 heads rel "
          + ", ".join(f"{k} {e:.2e}" for k, e in e_shapes.items())
          + f" (tol {TOL_RANDOM}); cancellation regime vs f64 rel "
          f"{e_cancel:.2e} (tol 2e-4)", flush=True)
    return model, config, errs[1024]


def phase_cancellation(device):
    """Distances on data with a large offset mean (||x|| >> ||x - c||), the
    regime of tests/test_pallas_rbf.py::test_distance_cancellation_regime:
    the kernel must stay within 2e-4 relative of an f64 reference."""
    import torch

    from irbfn_tpu_torch.models import WCRBFNet
    from irbfn_tpu_torch.ops import wcrbf_forward, wcrbf_params_to_kernel

    rng = np.random.default_rng(7)
    R, K, F, B = 2, 16, 8, 64
    mean = 100.0 * rng.normal(size=(F,))
    c = (mean[None, None] + 0.1 * rng.normal(size=(R, K, F))).astype(
        np.float32)
    x = (mean[None] + 0.1 * rng.normal(size=(B, F))).astype(np.float32)
    d_ref = np.sqrt(((x.astype(np.float64)[:, None, None]
                      - c.astype(np.float64)[None]) ** 2).sum(-1))
    gref = np.exp(-d_ref ** 2).sum(1)
    model = WCRBFNet(F, K, K, "gaussian", R, [[-1e30]], [[1e30]], [[0], [0]],
                     [0], [1.0], device=device)
    model.load_state_dict({
        "centers": torch.from_numpy(c), "log_sigs": torch.zeros(R, K),
        "head_kernel": torch.eye(K), "head_bias": torch.zeros(K)})
    with torch.no_grad():
        out = wcrbf_forward(torch.from_numpy(x).to(device),
                            wcrbf_params_to_kernel(model))
    torch.cuda.synchronize()
    rel = np.abs(out.cpu().numpy() - gref) / np.maximum(np.abs(gref), 5e-3)
    check(float(rel.max()) <= 2e-4,
          f"cancellation regime: rel err {rel.max():.3e} > 2e-4")
    return float(rel.max())


def phase_against_jax(device, model, config, golden):
    import torch

    from irbfn_tpu_torch.planning import IRBFNFrenetPlanner
    from irbfn_tpu_torch.sim import oval_track
    from irbfn_tpu_torch.train import input_bounds_from_config

    x = torch.as_tensor(golden["x"], device=device)
    with torch.no_grad():
        out = model(x)
    e_fwd = _max_err(out.cpu(), torch.from_numpy(golden["forward_f64"]))
    check(e_fwd <= TOL_FLAGSHIP, f"forward vs JAX f64: {e_fwd:.3e}")
    track = oval_track(30.0, 15.0, n_samples=512, speed=3.0, device=device)
    planner = IRBFNFrenetPlanner(model, track,
                                 input_bounds=input_bounds_from_config(config))
    res = planner.plan_batch(*torch.as_tensor(golden["plan_in"],
                                              device=device).T)
    e_plan = {k: _max_err(v.cpu(), torch.from_numpy(golden[f"plan_{k}"]))
              for k, v in res._asdict().items()}
    bad = {k: e for k, e in e_plan.items() if not e <= TOL_FLAGSHIP}
    check(not bad, f"plan_batch vs JAX f64: {bad}")
    n_m = int((golden["plan_in"][:, 1] < -0.05).sum())
    print(f"against JAX (f64 goldens, tol {TOL_FLAGSHIP}): forward max|err| "
          f"{e_fwd:.2e}; plan_batch ({n_m} of {len(golden['plan_in'])} rows "
          "mirrored) " + ", ".join(f"{k} {e:.2e}" for k, e in e_plan.items()),
          flush=True)
    return track, planner


def _drive(env, sim, policy, kernel):
    """One closed loop of N_STEPS with the launch counts set to 0 just
    before and read just after; the path's kernel must have launched once
    per control step. Returns (final, traj, launches, seconds)."""
    import torch

    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    final, traj = env.rollout(sim, policy, N_STEPS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    check(launches[kernel] == N_STEPS,
          f"{kernel} launches {launches[kernel]} != control steps {N_STEPS}")
    check(bool(torch.isfinite(traj.obs.ey).all()), "NaN in the closed loop")
    return final, traj, launches, wall


def phase_closed_loop(device, planner, golden):
    import torch

    from irbfn_tpu_torch.sim import deviation_metrics
    from irbfn_tpu_torch.utils.profiling import sweep_env

    env, sim = sweep_env(device, "accl", golden)
    B = sim.s.numel()

    def policy(obs):
        r = planner.plan_batch(obs.s, obs.ey, obs.epsi, obs.delta,
                               obs.linear_vel_x, obs.linear_vel_y,
                               obs.ang_vel_z)
        return torch.stack([r.accel, r.steer_vel], dim=-1)

    final, traj, launches, wall = _drive(env, sim, policy, "rbf_forward")
    ey_mean, _ = deviation_metrics(traj)
    ey = ey_mean.cpu().numpy()
    done = final.done.cpu().numpy()
    laps = final.laps.cpu().numpy()
    done_ref = golden["loop_done"]
    d_ey_mm = 1e3 * np.abs(ey - golden["loop_ey_mean"])
    n_done_diff = int((done != done_ref).sum())
    n_lap_diff = int((laps != golden["loop_laps"]).sum())
    d_sweep_mm = 1e3 * abs(float(ey.mean())
                           - float(golden["loop_ey_mean"].mean()))
    print(f"Frenet closed loop: {int((~done).sum())}/{B} lanes completed "
          f"(JAX {int((~done_ref).sum())}), laps>=1 {int((laps >= 1).sum())}"
          f"; mean|ey| {ey.mean():.4f} m (JAX {golden['loop_ey_mean'].mean():.4f}"
          f"), sweep diff {d_sweep_mm:.4f} mm, per-lane max diff "
          f"{d_ey_mm.max():.2f} mm, {n_lap_diff} lanes' "
          f"laps differ; {N_STEPS} steps in "
          f"{wall:.2f} s = {N_STEPS / wall:.1f} control steps/s "
          f"({B * N_STEPS / wall:.0f} lane-steps/s); kernel launches "
          f"{launches}", flush=True)
    check(n_done_diff == 0, f"{n_done_diff} lanes differ from JAX in done")
    check(n_lap_diff <= TOL_LAP_LANES and int(np.abs(
        laps - golden["loop_laps"]).max()) <= 1,
        f"{n_lap_diff} lanes differ from JAX in laps")
    check(float(d_ey_mm.max()) <= TOL_EY_LANE_MM,
          f"per-lane mean|ey| differs from JAX by {d_ey_mm.max():.2f} mm")
    check(d_sweep_mm <= TOL_EY_SWEEP_MM,
          f"sweep mean|ey| differs from JAX by {d_sweep_mm:.4f} mm")
    return launches["rbf_forward"]


def _time_ms(fn, iters=200, warmup=20):
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _in_turns(plain, kernel, iters=200, warmup=20):
    """Plain, kernel, kernel, plain; mean ms of each and the runs."""
    t = {"plain": [], "kernel": []}
    for name in ("plain", "kernel", "kernel", "plain"):
        t[name].append(_time_ms(plain if name == "plain" else kernel,
                                iters, warmup))
    return {k: float(np.mean(v)) for k, v in t.items()}, t


def _rbf_flops(B, ops) -> float:
    """Operations of one forward: per (row, region, kernel) a difference
    and an FMA per feature, the root, the width, the basis (~3), the gate
    weight and an FMA per output; per (row, region) the gate's 8 per
    feature."""
    R, K, F = ops.centers.shape
    O = ops.w.shape[-1]
    return float(B * R * K * (3 * F + 6 + 2 * O) + B * R * F * 8)


def _bound(flops, nbytes):
    t_ops = flops / PEAK_F32_FLOPS * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    return (max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes")


def phase_times(device, model, golden):
    """The flagship forward at B=1024 and B=1, kernel vs plain, timed in
    turns, and what an empty launch costs (the floor under a forward, which
    is two launches)."""
    import torch

    from irbfn_tpu_torch.ops import rbf

    ops = rbf.wcrbf_params_to_kernel(model)
    x = (torch.as_tensor(golden["x"], device=device)
         * model.input_scale).contiguous()
    x1 = x[:1].contiguous()
    with torch.no_grad():
        ms, t = _in_turns(lambda: rbf.wcrbf_forward_reference(x, ops),
                          lambda: rbf.wcrbf_forward(x, ops))
        ms1, t1 = _in_turns(lambda: rbf.wcrbf_forward_reference(x1, ops),
                            lambda: rbf.wcrbf_forward(x1, ops))
    floor = [_time_ms(rbf.empty_launch, iters=1000) for _ in range(2)]
    nbytes = 4 * (sum(o.numel() for o in ops[:7]) + x.numel()
                  + x.shape[0] * ops.w.shape[-1])
    bound_ms, bound_by = _bound(_rbf_flops(x.shape[0], ops), nbytes)
    print(f"times, flagship forward (CUDA events, mean of 2 x 200 calls): "
          f"B=1024 kernel {ms['kernel']:.4f} ms, plain {ms['plain']:.4f} ms"
          f" (runs {t['kernel']} / {t['plain']}), bound {bound_ms:.4f} ms "
          f"by {bound_by}; B=1 kernel {ms1['kernel']:.4f} ms, plain "
          f"{ms1['plain']:.4f} ms (runs {t1['kernel']} / {t1['plain']}); "
          f"an empty launch {min(floor):.5f} ms (runs {floor}), a forward is "
          "two launches", flush=True)
    return dict(ms=ms["kernel"], plain_ms=ms["plain"], bound_ms=bound_ms,
                bound_by=bound_by, library_ms=None)


# ------------------------------------------------------------- goal-MPC path

def _admm_operands(v_car, goals):
    """The ADMM operands of v_car (F,) and goals (F, G, 4) on their device:
    (q, A, kinv, lo, hi, rho), contiguous."""
    from irbfn_tpu_torch.solvers import goal_mpc

    fam, rho, kinv, q = goal_mpc._family_operands(
        v_car, goals, goal_mpc.GoalMPCConfig(), 1e-6)
    return tuple(t.contiguous() for t in (q, fam.A_con, kinv, fam.lo,
                                          fam.hi, rho))


def _admm_errors(ops, iters, fn_a, fn_b):
    """Run two ADMM versions on the same operands; per-quantity max |err|
    (speed = a_0 dt, steer, controls, r_prim, r_dual) and the converged
    flags that differ, with the per-row control errors."""
    import torch

    xa, pa, da = fn_a(*ops, iters=iters)
    xb, pb, db = fn_b(*ops, iters=iters)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(xa).all() & torch.isfinite(pa).all()),
          "non-finite ADMM output")
    row_err = (xa.double() - xb.double()).abs().amax(-1)  # (F, G)
    err = {"speed": 0.05 * float((xa[..., 0].double()
                                  - xb[..., 0].double()).abs().max()),
           "steer": float((xa[..., 1].double()
                           - xb[..., 1].double()).abs().max()),
           "controls": float(row_err.max()),
           "r_prim": float((pa.double() - pb.double()).abs().max()),
           "r_dual": float((da.double() - db.double()).abs().max())}
    conv_a = (pa < 2e-3) & (da < 2e-3)
    conv_b = (pb < 2e-3) & (db < 2e-3)
    return (err, _flips(conv_a, conv_b, torch.maximum(pb, db)), row_err,
            conv_a)


def _flips(conv, conv_ref, res_ref):
    """(converged flags that differ, those outside the noise band around
    the 2e-3 tolerance of the reference's residual)."""
    diff = conv != conv_ref
    near = (res_ref - 2e-3).abs() <= TOL_RES_BAND
    return int(diff.sum()), int((diff & ~near).sum())


def _plain_f64(*ops, iters):
    """The plain ADMM in f64 arithmetic, its outputs rounded to f32."""
    from irbfn_tpu_torch.ops import admm

    return tuple(t.float() for t in admm.admm_solve_reference(
        *(o.double() for o in ops), iters=iters))


def _check_admm(label, err, flips):
    check(err["speed"] <= TOL_SPEED and err["steer"] <= TOL_STEER
          and err["controls"] <= TOL_CONTROLS and err["r_prim"] <= TOL_RPRIM
          and flips[1] == 0,
          f"{label}: kernel vs plain {err}; converged flags differ in "
          f"{flips[0]} rows, {flips[1]} of them outside the noise band")


def _lattice_goals():
    """The reference lattice's goal block (G, 4), solver order (x, y, v, t),
    and its v_car values."""
    from irbfn_tpu_torch.parallel import build_lattice
    from irbfn_tpu_torch.parallel import gen_goal_mpc_table as gen

    grid = gen.grid_from_args(gen.parse_args(list(LATTICE_ARGS)))
    goals_raw = build_lattice(grid[1:])
    return goals_raw[:, [0, 1, 3, 2]].copy(), grid[0].values()


def phase_admm_vs_plain(device, lattice_goals):
    import torch

    from irbfn_tpu_torch.ops import admm

    rng = np.random.default_rng(1)
    worst, n_flips = {}, 0
    for v in (-1.0, 4.5, 8.0):  # (i) one family, ragged and tiny G
        for G in (1, 7, 96, 4097):
            goals = np.stack([rng.uniform(-1.2, 4.0, G),
                              rng.uniform(0.0, 4.0, G),
                              rng.uniform(-1.0, 8.0, G),
                              rng.uniform(-3.14, 3.14, G)], axis=1)
            ops = _admm_operands(
                torch.tensor([v], device=device),
                torch.as_tensor(goals[None], dtype=torch.float32,
                                device=device))
            for iters in (300, 600):
                err, flips, _, _ = _admm_errors(ops, iters, admm.admm_solve,
                                                admm.admm_solve_reference)
                _check_admm(f"v={v} G={G} iters={iters}", err, flips)
                worst = {k: max(e, worst.get(k, 0.0)) for k, e in err.items()}
                n_flips += flips[0]
    print("ADMM kernel vs plain, one family, v_car {-1, 4.5, 8} x G {1, 7, "
          "96, 4097} x {300, 600} sweeps: max|err| "
          + ", ".join(f"{k} {e:.2e}" for k, e in worst.items())
          + f"; {n_flips} converged flags differ, all within "
          f"{TOL_RES_BAND} of the tolerance (tol speed {TOL_SPEED}, steer "
          f"{TOL_STEER}, controls {TOL_CONTROLS}, r_prim {TOL_RPRIM})",
          flush=True)

    # (ii) two whole reference families, row by row
    g = torch.as_tensor(lattice_goals, device=device)
    fam_err = 0.0
    for v in (-1.0, 8.0):
        ops = _admm_operands(torch.tensor([v], device=device), g[None])
        err, flips, row_err, conv = _admm_errors(
            ops, 600, admm.admm_solve, admm.admm_solve_reference)
        p999 = float(torch.quantile(row_err[0, ::7].float(), 0.999))
        print(f"ADMM kernel vs plain, whole family v_car={v:+.1f} "
              f"({g.shape[0]:,} goals, 600 sweeps): max|err| "
              + ", ".join(f"{k} {e:.2e}" for k, e in err.items())
              + f"; controls p99.9 {p999:.2e} (every 7th row); {flips[0]} "
              f"converged flags differ ({flips[1]} outside the noise band);"
              f" kernel converged {float(conv.double().mean()):.6f}",
              flush=True)
        _check_admm(f"family v_car={v}", err, flips)
        fam_err = max(fam_err, err["controls"])
        if v == 8.0:  # the yardstick of TOL_CONTROLS: plain f32 vs f64
            e64, _, _, _ = _admm_errors(ops, 600, admm.admm_solve_reference,
                                        _plain_f64)
            print("  plain f32 vs plain f64 on the same operands: max|err| "
                  + ", ".join(f"{k} {e:.2e}" for k, e in e64.items()),
                  flush=True)
        del ops

    # (iii) the planner's shape, 1000 one-goal families, and shapes on both
    # sides of the variant rule: few rows, a ragged last block of the family
    # variant, several families in one family-variant launch
    per_block = admm.FAMILY_BLOCK_ROWS
    shapes = ((1000, 1), (19, 1000), (3, 33), (1, 1),
              (1, admm.FAMILY_MIN_ROWS + per_block // 2 + 23),
              (3, admm.FAMILY_MIN_ROWS // 2 + 5))
    check({admm.admm_variant(*fg) for fg in shapes} == set(admm.VARIANTS)
          and admm.admm_variant(*shapes[4]) == "family"
          and shapes[4][1] % per_block, "the shapes miss a variant")
    lines = []
    for F, G in shapes:
        goals = np.stack([rng.uniform(-1.2, 4.0, F * G),
                          rng.uniform(0.0, 4.0, F * G),
                          rng.uniform(-1.0, 8.0, F * G),
                          rng.uniform(-3.14, 3.14, F * G)], axis=1)
        ops = _admm_operands(
            torch.as_tensor(rng.uniform(-1.0, 8.0, F), dtype=torch.float32,
                            device=device),
            torch.as_tensor(goals.reshape(F, G, 4), dtype=torch.float32,
                            device=device))
        err, flips, _, _ = _admm_errors(ops, 600, admm.admm_solve,
                                        admm.admm_solve_reference)
        _check_admm(f"F={F} G={G}", err, flips)
        twice = [admm.admm_solve(*ops, iters=600) for _ in range(2)]
        check(all(torch.equal(a, b) for a, b in zip(*twice)),
              f"two ADMM solves of one input differ at F={F} G={G}")
        lines.append(f"({F}, {G}) {admm.admm_variant(F, G)} controls "
                     f"{err['controls']:.2e} r_prim {err['r_prim']:.2e} "
                     f"r_dual {err['r_dual']:.2e}")
    print("ADMM kernel vs plain, (F, G) across the variant rule, 600 sweeps, "
          "max|err|: " + "; ".join(lines) + "; two solves of each bitwise "
          "equal", flush=True)
    return fam_err


def phase_goal_net(device, golden):
    """The RBF kernel at the goal net's width (F=5, O=2)."""
    import torch

    from irbfn_tpu_torch.ops import wcrbf_params_to_kernel
    from irbfn_tpu_torch.train import load_model

    model, config = load_model(GOAL_ASSET + ".json", GOAL_ASSET + ".npz",
                               device=device)
    model.eval()
    ops = wcrbf_params_to_kernel(model)
    x = torch.as_tensor(golden["net_x"], device=device)
    xs = (x * model.input_scale).contiguous()
    errs = {B: _compare(f"goal net B={B}", xs[:B].contiguous(), ops,
                        TOL_GOAL_NET) for B in (1, 7, 1000, 1024)}
    with torch.no_grad():
        out = model(x)
    e64 = _max_err(out.cpu(), torch.from_numpy(golden["net_forward_f64"]))
    check(e64 <= TOL_GOAL_NET, f"goal net vs JAX f64: {e64:.3e}")
    print("RBF kernel at the goal net's width (R=16, K=512, F=5, O=2): "
          "vs plain max|err| " + ", ".join(f"B={b} {e:.2e}"
                                           for b, e in errs.items())
          + f"; forward vs JAX f64 {e64:.2e} (tol {TOL_GOAL_NET})",
          flush=True)
    return model


def phase_goal_against_jax(device, golden, net):
    import torch

    from irbfn_tpu_torch.planning import GoalMPCPlanner
    from irbfn_tpu_torch.sim import oval_track
    from irbfn_tpu_torch.solvers import solve_goal_family

    sols = [solve_goal_family(float(v), torch.as_tensor(g, device=device),
                              iters=600)
            for v, g in zip(golden["lat_v"], golden["lat_goals"])]
    port = {k: torch.stack([getattr(s, k) for s in sols]).cpu().numpy()
            for k in sols[0]._fields}
    e = {(k, d): float(np.abs(port[k].astype(np.float64)
                              - golden[f"lat_{k}_{d}"]).max())
         for k in ("speed", "steer", "controls", "r_prim", "r_dual")
         for d in ("f32", "f64")}
    flips = {d: _flips(torch.from_numpy(port["converged"]),
                       torch.from_numpy(golden[f"lat_converged_{d}"]),
                       torch.from_numpy(np.maximum(golden[f"lat_r_prim_{d}"],
                                                   golden[f"lat_r_dual_{d}"])))
             for d in ("f32", "f64")}
    jax32 = float(np.abs(golden["lat_controls_f32"].astype(np.float64)
                         - golden["lat_controls_f64"]).max())
    print(f"goal-MPC vs JAX, {port['speed'].size} lattice rows x 600 sweeps "
          "through the kernel: vs f64 speed "
          f"{e['speed', 'f64']:.2e} steer {e['steer', 'f64']:.2e} (tol "
          f"{TOL_F64}) controls {e['controls', 'f64']:.2e} (JAX's own f32 "
          f"loop: {jax32:.2e}); vs f32 speed {e['speed', 'f32']:.2e} steer "
          f"{e['steer', 'f32']:.2e} controls {e['controls', 'f32']:.2e} "
          f"r_prim {e['r_prim', 'f32']:.2e} r_dual {e['r_dual', 'f32']:.2e}; "
          f"converged flags differing from JAX f32/f64 {flips['f32'][0]}/"
          f"{flips['f64'][0]} ({flips['f32'][1]}/{flips['f64'][1]} outside "
          f"the noise band); converged {port['converged'].mean():.4f}",
          flush=True)
    check(e["speed", "f64"] <= TOL_F64 and e["steer", "f64"] <= TOL_F64,
          "lattice rows vs JAX f64")
    check(e["speed", "f32"] <= TOL_SPEED and e["steer", "f32"] <= TOL_STEER
          and e["controls", "f32"] <= TOL_CONTROLS
          and e["r_prim", "f32"] <= TOL_RPRIM and flips["f32"][1] == 0,
          "lattice rows vs JAX f32")

    track = oval_track(30.0, 15.0, n_samples=512, speed=3.0, device=device)
    pose = torch.as_tensor(golden["plan_pose"], dtype=torch.float32,
                           device=device)
    line = []
    for mode, planner in (("solver", GoalMPCPlanner(track)),
                          ("net", GoalMPCPlanner(track, net))):
        out = planner.plan_batch(*pose.T)
        for k, v in zip(("speed", "steer"), out):
            err = _max_err(v.cpu(), torch.from_numpy(
                golden[f"plan_{mode}_{k}_f64"]))
            check(err <= TOL_GOAL_NET, f"{mode} plan_batch {k} vs JAX f64: "
                                       f"{err:.3e}")
            line.append(f"{mode} {k} {err:.2e}")
    print(f"GoalMPCPlanner.plan_batch vs JAX f64 on {pose.shape[0]} poses "
          f"(tol {TOL_GOAL_NET}): " + ", ".join(line), flush=True)


def phase_lattice(device):
    """The whole reference lattice through the table generator's solve."""
    import torch

    from irbfn_tpu_torch.parallel import gen_goal_mpc_table as gen

    args = gen.parse_args(list(LATTICE_ARGS) + ["--device", str(device)])
    torch.cuda.synchronize()
    reset_launches()
    res = gen.solve_table(args)
    launches = read_launches()
    n_fam, G = res["speed"].shape
    per_family = -(-G // args.chunk)
    check(launches["admm_solve"] == n_fam * per_family,
          f"lattice launches {launches} != {n_fam} x {per_family}")
    check(bool(np.isfinite(res["speed"]).all()
               and np.isfinite(res["steer"]).all()),
          "non-finite lattice outputs")
    n = res["speed"].size
    print(f"goal lattice: {n:,} QPs x {args.iters} sweeps in "
          f"{res['seconds']:.2f} s = {n / res['seconds']:,.0f} QP solves/s; "
          f"converged {100 * res['valid'].mean():.4f}% (the JAX package's "
          f"claim: every row), {int((~res['valid']).sum())} rows not; "
          f"kernel launches {launches}", flush=True)
    return launches["admm_solve"], n / res["seconds"]


def phase_goal_loop(device, golden, mode, net):
    import torch

    from irbfn_tpu_torch.planning import GoalMPCPlanner
    from irbfn_tpu_torch.sim import deviation_metrics
    from irbfn_tpu_torch.utils.profiling import sweep_env

    env, sim = sweep_env(device, "speed", golden)
    planner = GoalMPCPlanner(env.track, None if mode == "solver" else net)
    B = sim.s.numel()

    def policy(obs):
        return torch.stack(planner.plan_batch(obs.pose_x, obs.pose_y,
                                              obs.pose_theta,
                                              obs.linear_vel_x), dim=-1)

    kernel = "admm_solve" if mode == "solver" else "rbf_forward"
    final, traj, launches, wall = _drive(env, sim, policy, kernel)
    ey = deviation_metrics(traj)[0].cpu().numpy()
    done = final.done.cpu().numpy()
    laps = final.laps.cpu().numpy()
    ref = {k: golden[f"loop_{mode}_{k}"] for k in ("done", "laps",
                                                    "ey_mean")}
    d_ey_mm = 1e3 * np.abs(ey - ref["ey_mean"])
    d_sweep_mm = 1e3 * abs(float(ey.mean()) - float(ref["ey_mean"].mean()))
    n_done_diff = int((done != ref["done"]).sum())
    n_lap_diff = int((laps != ref["laps"]).sum())
    print(f"goal-MPC closed loop, {mode} mode: {int((~done).sum())}/{B} "
          f"lanes completed (JAX {int((~ref['done']).sum())}), laps>=1 "
          f"{int((laps >= 1).sum())}; mean|ey| {ey.mean():.4f} m (JAX "
          f"{ref['ey_mean'].mean():.4f}), sweep diff {d_sweep_mm:.4f} mm, "
          f"per-lane diff median {np.median(d_ey_mm):.3f} mm, max "
          f"{d_ey_mm.max():.2f} mm, {n_lap_diff} lanes' laps differ; "
          f"{N_STEPS} steps in {wall:.2f} s = {N_STEPS / wall:.1f} control "
          f"steps/s ({B * N_STEPS / wall:.0f} lane-steps/s); kernel launches "
          f"{launches}", flush=True)
    check(n_done_diff == 0, f"{n_done_diff} lanes differ from JAX in done")
    check(n_lap_diff <= TOL_GOAL_LAP_LANES and int(np.abs(
        laps - ref["laps"]).max()) <= 1,
        f"{n_lap_diff} lanes differ from JAX in laps")
    check(float(np.median(d_ey_mm)) <= TOL_GOAL_EY_MEDIAN_MM
          and float(d_ey_mm.max()) <= TOL_GOAL_EY_LANE_MM,
          f"per-lane mean|ey| differs from JAX by {np.median(d_ey_mm):.3f} "
          f"mm median, {d_ey_mm.max():.2f} mm at most")
    check(d_sweep_mm <= TOL_GOAL_EY_SWEEP_MM,
          f"sweep mean|ey| differs from JAX by {d_sweep_mm:.4f} mm")
    return launches[kernel], N_STEPS / wall


def _admm_flops(F, G, iters) -> float:
    """Operations of one ADMM solve at T=8 (n=16, m=31): per sweep and row
    the three products' 2 (2 m n + n n) and ~8 m elementwise, and the
    residuals' 4 m n + 6 m once."""
    n, m = 16, 31
    return float(F * G * (iters * (2 * (2 * m * n + n * n) + 8 * m)
                          + 4 * m * n + 6 * m))


def _admm_bytes(F, G) -> float:
    """q in, x and both residuals out, per row; the family operands once."""
    n, m = 16, 31
    return float(4 * (F * G * (2 * n + 2) + F * (m * n + n * n + 2 * m + 1)))


def phase_goal_times(device, lattice_goals, net, golden):
    import torch

    from irbfn_tpu_torch.ops import admm, rbf

    g = torch.as_tensor(lattice_goals, device=device)
    fam_ops = _admm_operands(torch.tensor([8.0], device=device), g[None])
    ms_fam, t_fam = _in_turns(
        lambda: admm.admm_solve_reference(*fam_ops, iters=600),
        lambda: admm.admm_solve(*fam_ops, iters=600), iters=1, warmup=1)
    # the same family as the table generator launches it: chunks of 262,144
    chunk = 262144
    parts = [(fam_ops[0][:, i:i + chunk].contiguous(),) + fam_ops[1:]
             for i in range(0, g.shape[0], chunk)]

    def chunks():
        for p in parts:
            admm.admm_solve(*p, iters=600)

    t_chunks = [_time_ms(chunks, iters=1, warmup=1) for _ in range(2)]
    del fam_ops, parts
    rng = np.random.default_rng(2)
    F = 1000
    goals = torch.as_tensor(lattice_goals[rng.choice(len(lattice_goals), F)],
                            device=device)
    row_ops = _admm_operands(
        torch.as_tensor(rng.uniform(-1.0, 8.0, F), dtype=torch.float32,
                        device=device), goals[:, None])
    ms_row, t_row = _in_turns(
        lambda: admm.admm_solve_reference(*row_ops, iters=600),
        lambda: admm.admm_solve(*row_ops, iters=600), iters=10, warmup=2)
    ops = rbf.wcrbf_params_to_kernel(net)
    x = (torch.as_tensor(golden["net_x"], device=device)
         * net.input_scale).contiguous()
    with torch.no_grad():
        ms_net, t_net = _in_turns(
            lambda: rbf.wcrbf_forward_reference(x, ops),
            lambda: rbf.wcrbf_forward(x, ops))
    G = len(lattice_goals)
    b_fam = _bound(_admm_flops(1, G, 600), _admm_bytes(1, G))
    b_row = _bound(_admm_flops(F, 1, 600), _admm_bytes(F, 1))
    b_net = _bound(_rbf_flops(x.shape[0], ops), 4 * (
        sum(o.numel() for o in ops[:7]) + x.numel() + 2 * x.shape[0]))
    print(f"times (CUDA events, in turns): ADMM whole family ({G:,} goals, "
          f"600 sweeps) kernel {ms_fam['kernel']:.3f} ms, plain "
          f"{ms_fam['plain']:.3f} ms (runs {t_fam['kernel']} / "
          f"{t_fam['plain']}), bound {b_fam[0]:.3f} ms by {b_fam[1]}; the "
          f"family as {-(-G // chunk)} launches of {chunk:,} "
          f"{min(t_chunks):.3f} ms (runs {t_chunks}); "
          f"ADMM F=1000 one-goal families kernel {ms_row['kernel']:.4f} ms, "
          f"plain {ms_row['plain']:.4f} ms (runs {t_row['kernel']} / "
          f"{t_row['plain']}), bound {b_row[0]:.5f} ms by {b_row[1]}; "
          f"goal net B=1024 forward kernel {ms_net['kernel']:.4f} ms, plain "
          f"{ms_net['plain']:.4f} ms (runs {t_net['kernel']} / "
          f"{t_net['plain']}), bound {b_net[0]:.5f} ms by {b_net[1]}",
          flush=True)
    return dict(ms=ms_fam["kernel"], plain_ms=ms_fam["plain"],
                bound_ms=b_fam[0], bound_by=b_fam[1], library_ms=None)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise SmokeFailure("no CUDA device: chip_smoke.py runs on a GPU only")
    sys.path.insert(0, ROOT)
    import irbfn_tpu_torch  # noqa: F401  (the port; fails outside the repo)

    t_start = time.perf_counter()
    device = phase_device()
    phase_build()
    with np.load(ASSET + "_golden.npz") as z:
        golden = {k: z[k] for k in z.files}
    with np.load(GOAL_GOLDEN) as z:
        goal_golden = {k: z[k] for k in z.files}
    # the learned Frenet planner
    model, config, err_1024 = phase_kernel_vs_plain(device, golden)
    track, planner = phase_against_jax(device, model, config, golden)
    rbf_launches = phase_closed_loop(device, planner, golden)
    rbf_times = phase_times(device, model, golden)
    # the goal-MPC path
    lattice_goals, _ = _lattice_goals()
    admm_err = phase_admm_vs_plain(device, lattice_goals)
    net = phase_goal_net(device, goal_golden)
    phase_goal_against_jax(device, goal_golden, net)
    phase_lattice(device)
    admm_launches, _ = phase_goal_loop(device, goal_golden, "solver", net)
    phase_goal_loop(device, goal_golden, "net", net)
    admm_times = phase_goal_times(device, lattice_goals, net, goal_golden)
    print(f"all phases passed in {time.perf_counter() - t_start:.1f} s",
          flush=True)
    print(json.dumps({"kernels": [
        dict(KERNELS["rbf_forward"], launches=rbf_launches,
             max_abs_err=err_1024, **rbf_times),
        dict(KERNELS["admm_solve"], launches=admm_launches,
             max_abs_err=admm_err, **admm_times)]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"FAILED: {e}", file=sys.stderr, flush=True)
        sys.exit(1)
