#!/usr/bin/env python3
"""Times of the port's two CUDA kernels on one card, shape by shape.

A quicker loop than ``chip_smoke.py`` for work on a kernel: builds both
``irbfn_tpu_torch/ops/csrc/*.cu``, prints what ``ptxas -v`` says, and for
each shape prints the kernel's time under CUDA events and its largest
difference from the plain PyTorch version on the same inputs:

- ``rbf_forward``: the flagship ``frenet_wide_pr1`` net and the
  ``goal_mpc_pr`` net at B in {1, 7, 1024, 4096};
- ``admm_solve`` at 600 sweeps: one whole lattice family (2,642,368 goals)
  in one launch and as the table generator's 11 chunks of 262,144, and the
  (F, G) shapes (1000, 1), (19, 1000), (3, 33), (1, 1), (1, 4097),
  (1, 40000) and (1, 262144);
- the flagship forward's device time by kernel under ``torch.profiler``,
  and the cost of an empty launch.

Usage, from the repository root on a machine with a GPU:
``python3 scripts/bench_kernels.py [--skip-family] [--only rbf|admm]
[--sass DIR]``
"""

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402  (the smoke run's helpers)


def bench_rbf(device):
    import torch

    from irbfn_tpu_torch.ops import rbf
    from irbfn_tpu_torch.train import load_model

    with np.load(cs.ASSET + "_golden.npz") as z:
        x_flag = z["x"]
    with np.load(cs.GOAL_GOLDEN) as z:
        x_goal = z["net_x"]
    flagship, _ = cs._flagship(device)
    goal, _ = load_model(cs.GOAL_ASSET + ".json", cs.GOAL_ASSET + ".npz",
                         device=device)
    for name, model, x_np in (("flagship", flagship, x_flag),
                              ("goal_mpc_pr", goal.eval(), x_goal)):
        ops = rbf.wcrbf_params_to_kernel(model)
        x_all = (torch.as_tensor(np.tile(x_np, (4, 1)), device=device)
                 * model.input_scale).contiguous()
        for B in (1, 7, 1024, 4096):
            x = x_all[:B].contiguous()
            with torch.no_grad():
                err = cs._max_err(rbf.wcrbf_forward(x, ops),
                                  rbf.wcrbf_forward_reference(x, ops))
                runs = [cs._time_ms(lambda: rbf.wcrbf_forward(x, ops))
                        for _ in range(2)]
            print(f"rbf_forward {name} B={B}: kernel {min(runs):.4f} ms "
                  f"(runs {runs}), vs plain max|err| {err:.2e}", flush=True)
    profile_rbf(flagship, x_flag, device)
    runs = [cs._time_ms(rbf.empty_launch, iters=1000) for _ in range(2)]
    print(f"empty launch: {min(runs):.5f} ms (runs {runs})", flush=True)


def profile_rbf(model, x_np, device):
    """Device time by kernel name of the flagship forward at B in {1, 1024}
    under torch.profiler (100 forwards each)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from irbfn_tpu_torch.ops import rbf

    ops = rbf.wcrbf_params_to_kernel(model)
    for B in (1, 1024):
        x = (torch.as_tensor(x_np[:B], device=device)
             * model.input_scale).contiguous()
        with torch.no_grad():
            for _ in range(10):
                rbf.wcrbf_forward(x, ops)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for _ in range(100):
                    rbf.wcrbf_forward(x, ops)
                torch.cuda.synchronize()
        rows = [(e.key[:60], e.count, e.self_device_time_total / e.count)
                for e in prof.key_averages() if e.self_device_time_total > 0]
        print(f"rbf_forward flagship B={B} under the profiler, us per launch: "
              + "; ".join(f"{k} x{n}: {t:.2f}" for k, n, t in rows),
              flush=True)


def dump_sass(out_dir):
    """cuobjdump -sass of both libraries into ``out_dir``."""
    import subprocess

    from irbfn_tpu_torch.ops import KERNELS as OPS, _build

    os.makedirs(out_dir, exist_ok=True)
    tool = os.path.join(os.path.dirname(_build.find_nvcc()), "cuobjdump")
    for name, mod in OPS.items():
        res = subprocess.run([tool, "-sass", str(mod.build_kernel().path)],
                             capture_output=True, text=True)
        with open(os.path.join(out_dir, f"{name}.sass"), "w") as f:
            f.write(res.stdout + res.stderr)
        print(f"SASS of {name}: {len(res.stdout.splitlines())} lines in "
              f"{out_dir}/{name}.sass", flush=True)


def bench_admm(device, skip_family):
    import torch

    from irbfn_tpu_torch.ops import admm

    rng = np.random.default_rng(2)
    lattice_goals, _ = cs._lattice_goals()

    def operands(F, G):
        goals = lattice_goals[rng.choice(len(lattice_goals), F * G)]
        v = rng.uniform(-1.0, 8.0, F)
        return cs._admm_operands(
            torch.as_tensor(v, dtype=torch.float32, device=device),
            torch.as_tensor(goals.reshape(F, G, 4), device=device))

    for F, G in ((1000, 1), (19, 1000), (3, 33), (1, 1), (1, 4097),
                 (1, 40000), (1, 262144)):
        ops = operands(F, G)
        err, flips, _, _ = cs._admm_errors(ops, 600, admm.admm_solve,
                                           admm.admm_solve_reference)
        runs = [cs._time_ms(lambda: admm.admm_solve(*ops, iters=600),
                            iters=5, warmup=1) for _ in range(2)]
        print(f"admm_solve F={F} G={G}: kernel {min(runs):.4f} ms (runs "
              f"{runs}); vs plain controls {err['controls']:.2e} r_prim "
              f"{err['r_prim']:.2e} r_dual {err['r_dual']:.2e}, flags "
              f"differ {flips}", flush=True)
    if skip_family:
        return
    g = torch.as_tensor(lattice_goals, device=device)
    ops = cs._admm_operands(torch.tensor([8.0], device=device), g[None])
    err, flips, _, conv = cs._admm_errors(ops, 600, admm.admm_solve,
                                          admm.admm_solve_reference)
    runs = [cs._time_ms(lambda: admm.admm_solve(*ops, iters=600), iters=2,
                        warmup=1) for _ in range(2)]
    chunk = 262144
    parts = [tuple(t.contiguous() for t in
                   (ops[0][:, s:s + chunk],) + ops[1:])
             for s in range(0, g.shape[0], chunk)]

    def chunks():
        for p in parts:
            admm.admm_solve(*p, iters=600)

    runs_c = [cs._time_ms(chunks, iters=2, warmup=1) for _ in range(2)]
    print(f"admm_solve whole family v_car=8 ({g.shape[0]:,} goals): one "
          f"launch {min(runs):.3f} ms (runs {runs}); as {len(parts)} chunks "
          f"of {chunk:,} {min(runs_c):.3f} ms (runs {runs_c}); vs plain "
          f"controls {err['controls']:.2e}, flags differ {flips}, converged "
          f"{float(conv.double().mean()):.6f}", flush=True)


def main():
    import torch

    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--skip-family", action="store_true",
                   help="leave out the whole-family ADMM solves")
    p.add_argument("--only", choices=("rbf", "admm"), default=None)
    p.add_argument("--sass", default=None, metavar="DIR",
                   help="also write cuobjdump -sass of both libraries there")
    args = p.parse_args()
    device = cs.phase_device()
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    cs.phase_build()
    if args.sass:
        dump_sass(args.sass)
    if args.only != "admm":
        bench_rbf(device)
    if args.only != "rbf":
        bench_admm(device, args.skip_family)


if __name__ == "__main__":
    main()
