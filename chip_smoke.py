#!/usr/bin/env python3
"""On-card smoke run of the PyTorch port's serving path (one NVIDIA GPU).

Drives ``irbfn_tpu_torch`` -- the learned Frenet planner in closed loop,
with the flagship ``frenet_wide_pr1`` WCRBF net (R=16 regions, K=512
kernels, F=8 inputs, O=10 outputs, per-region heads) -- through these
phases; each prints one line, and any failure exits non-zero:

1. device: requires CUDA (never falls back to the CPU); prints the card's
   name and power limit as nvidia-smi reports them;
2. build: compiles ``irbfn_tpu_torch/ops/csrc/rbf_forward.cu`` into
   ``build/`` with nvcc;
3. kernel vs its plain PyTorch version on the card: the flagship at
   B in {1, 7, 1000, 1024}, a shared-head net of the same width, every basis
   function at a small shape, and the distance-cancellation regime;
4. against JAX: the forward and ``IRBFNFrenetPlanner.plan_batch`` against
   the goldens the JAX package wrote (``scripts/export_torch_ckpt.py``);
5. closed loop: the eval sweep's defaults, 10x10 (mu, cs) x 10 trials = 1000
   lanes x 600 control steps on the oval track, with the kernel's launches
   counted; completions and mean |ey| against the JAX golden;
6. times: the batch-1024 forward, kernel against the plain version, with
   CUDA events.

The last two lines are a JSON object naming the kernel with its launches,
error and times, and the line ``{"ok": true, "device": {...}}``.

Usage, from the repository root: ``python3 chip_smoke.py``
"""

import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
ASSET = os.path.join(ROOT, "irbfn_tpu_torch", "assets", "frenet_wide_pr1")
KERNEL = {"name": "rbf_forward", "route": "cuda",
          "source": "irbfn_tpu_torch/ops/csrc/rbf_forward.cu",
          "replaces": "irbfn_tpu/ops/pallas_rbf.py:45"}

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


def phase_build():
    from irbfn_tpu_torch.ops import build_kernel

    res = build_kernel()
    ptxas = " | ".join(line.strip() for line in res.log.splitlines()
                       if "registers" in line or "spill" in line)
    print(f"build: {res.path.name} in {res.seconds:.2f} s nvcc"
          f"{' (already built)' if res.seconds == 0.0 else ''}; {ptxas}",
          flush=True)


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
    its R = 2**n regions split the first n even dims at 0."""
    import torch

    from irbfn_tpu_torch.models import WCRBFNet

    n = R.bit_length() - 1
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
    from irbfn_tpu_torch.ops import wcrbf_params_to_kernel

    rng = np.random.default_rng(0)
    model, config = _flagship(device)
    ops = wcrbf_params_to_kernel(model)
    x = torch.as_tensor(golden["x"], device=device) * model.input_scale
    errs = {}
    for B in (1, 7, 1000, 1024):
        errs[B] = _compare(f"flagship B={B}", x[:B].contiguous(), ops,
                           TOL_FLAGSHIP)
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
    e_cancel = phase_cancellation(device)
    print("kernel vs plain: flagship max|err| "
          + ", ".join(f"B={b} {e:.2e}" for b, e in errs.items())
          + f" (tol {TOL_FLAGSHIP}); shared head R=16 K=512 rel {e_shared:.2e}"
          f"; 15 bases x 2 heads rel {e_basis:.2e} (tol {TOL_RANDOM}); "
          f"cancellation regime vs f64 rel {e_cancel:.2e} (tol 2e-4)",
          flush=True)
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


def phase_closed_loop(device, track, planner, golden):
    import torch

    from irbfn_tpu_torch.dynamics import VehicleParams, f1tenth_params
    from irbfn_tpu_torch.ops import wcrbf_forward
    from irbfn_tpu_torch.sim import TrackEnv, deviation_metrics

    n_steps = 600
    mu = torch.as_tensor(golden["loop_mu"], device=device)
    cs = torch.as_tensor(golden["loop_cs"], device=device)
    B = mu.numel()
    base = f1tenth_params(device=device)
    lane = {f: getattr(base, f).expand(B).contiguous()
            for f in ("m", "I", "lf", "lr", "h", "sv_max", "a_max", "s_max",
                      "v_max")}
    params = VehicleParams(mu=mu, C_Sf=cs, C_Sr=cs,
                           dt=torch.full((B,), 0.01, device=device), **lane)
    env = TrackEnv(track, params, half_width=2.0)
    sim = env.reset(s0=0.0, speed0=1.0, batch_shape=(B,), noise_scale=0.01,
                    noise=torch.as_tensor(golden["loop_noise"],
                                          device=device))

    def policy(obs):
        r = planner.plan_batch(obs.s, obs.ey, obs.epsi, obs.delta,
                               obs.linear_vel_x, obs.linear_vel_y,
                               obs.ang_vel_z)
        return torch.stack([r.accel, r.steer_vel], dim=-1)

    torch.cuda.synchronize()
    wcrbf_forward.launches = 0
    t0 = time.perf_counter()
    final, traj = env.rollout(sim, policy, n_steps)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = wcrbf_forward.launches
    ey_mean, _ = deviation_metrics(traj)
    ey = ey_mean.cpu().numpy()
    done = final.done.cpu().numpy()
    laps = final.laps.cpu().numpy()
    check(launches == n_steps, f"kernel launches {launches} != control "
                               f"steps {n_steps}")
    check(bool(np.isfinite(ey).all()) and bool(
        torch.isfinite(traj.obs.ey).all()), "NaN in the closed loop")
    done_ref = golden["loop_done"]
    d_ey_mm = 1e3 * np.abs(ey - golden["loop_ey_mean"])
    n_done_diff = int((done != done_ref).sum())
    n_lap_diff = int((laps != golden["loop_laps"]).sum())
    d_sweep_mm = 1e3 * abs(float(ey.mean())
                           - float(golden["loop_ey_mean"].mean()))
    print(f"closed loop: {int((~done).sum())}/{B} lanes completed "
          f"(JAX {int((~done_ref).sum())}), laps>=1 {int((laps >= 1).sum())}"
          f"; mean|ey| {ey.mean():.4f} m (JAX {golden['loop_ey_mean'].mean():.4f}"
          f"), sweep diff {d_sweep_mm:.4f} mm, per-lane max diff "
          f"{d_ey_mm.max():.2f} mm, {n_lap_diff} lanes' "
          f"laps differ; {n_steps} steps in "
          f"{wall:.2f} s = {n_steps / wall:.1f} control steps/s "
          f"({B * n_steps / wall:.0f} lane-steps/s); kernel launches "
          f"{launches}", flush=True)
    check(n_done_diff == 0, f"{n_done_diff} lanes differ from JAX in done")
    check(n_lap_diff <= TOL_LAP_LANES and int(np.abs(
        laps - golden["loop_laps"]).max()) <= 1,
        f"{n_lap_diff} lanes differ from JAX in laps")
    check(float(d_ey_mm.max()) <= TOL_EY_LANE_MM,
          f"per-lane mean|ey| differs from JAX by {d_ey_mm.max():.2f} mm")
    check(d_sweep_mm <= TOL_EY_SWEEP_MM,
          f"sweep mean|ey| differs from JAX by {d_sweep_mm:.4f} mm")
    return launches


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


def phase_times(device, model, golden):
    """Batch-1024 forward, kernel vs plain, timed in turns on one card."""
    import torch

    from irbfn_tpu_torch.ops import rbf

    ops = rbf.wcrbf_params_to_kernel(model)
    x = (torch.as_tensor(golden["x"], device=device)
         * model.input_scale).contiguous()
    with torch.no_grad():
        def plain():
            return rbf.wcrbf_forward_reference(x, ops)

        def kernel():
            return rbf.wcrbf_forward(x, ops)

        t = {"plain": [], "kernel": []}
        for name in ("plain", "kernel", "kernel", "plain"):
            t[name].append(_time_ms(plain if name == "plain" else kernel))
    ms = {k: float(np.mean(v)) for k, v in t.items()}
    print(f"times, B=1024 forward (CUDA events, mean of 2 x 200 calls): "
          f"kernel {ms['kernel']:.4f} ms, plain {ms['plain']:.4f} ms "
          f"(runs {t['kernel']} / {t['plain']})", flush=True)
    return ms


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise SmokeFailure("no CUDA device: chip_smoke.py runs on a GPU only")
    sys.path.insert(0, ROOT)
    import irbfn_tpu_torch  # noqa: F401  (the port; fails outside the repo)

    device = phase_device()
    phase_build()
    with np.load(ASSET + "_golden.npz") as z:
        golden = {k: z[k] for k in z.files}
    model, config, err_1024 = phase_kernel_vs_plain(device, golden)
    track, planner = phase_against_jax(device, model, config, golden)
    launches = phase_closed_loop(device, track, planner, golden)
    ms = phase_times(device, model, golden)
    print(json.dumps({"kernels": [dict(
        KERNEL, launches=launches, max_abs_err=err_1024, ms=ms["kernel"],
        plain_ms=ms["plain"])]}))
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
