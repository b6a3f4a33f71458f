"""The 2-D quadrotor (double-integrator) domain: MPC lattice, WCRBF fit,
off-grid and closed-loop evaluation, in one run.

Port of ``scripts/quadrotor_pipeline.py``, with its flags, prints and
files, plus ``--device`` and ``--out_dir`` (where the config and the
checkpoint go; the JAX script writes ``configs/`` and ``ckpts/``). The
condensed linear MPC (``solvers/qp.py``) solves a lattice of start states
toward the origin; a per-region WCRBF net (gaussian_wide basis) is fitted
to the first control in closed form; then the net is held against fresh
MPC solves off the grid, and both regulate a ring of 64 starts for 80 steps
(the net in the loop, one forward a step: on the card one ``rbf_forward``
kernel launch; and the MPC re-solved every step).

``run(args, device)`` does the computing and writes the table, the
checkpoint and ``quadrotor_results.json``; ``plot`` draws the figure (it
imports matplotlib).

Usage: ``python -m irbfn_tpu_torch.train.quadrotor_pipeline [--n_grid 9]
[--n_extra 32768] [--num_k 256] [--save_path torch_runs] [--out_dir
torch_runs] [--device cpu]``
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from irbfn_tpu_torch._device import resolve_device, wait_clock
from irbfn_tpu_torch.models import WCRBFNet
from irbfn_tpu_torch.models.fit import (choose_centers, data_scale,
                                        fit_per_region, install_fit)
from irbfn_tpu_torch.models.wcrbf import build_region_bounds
from irbfn_tpu_torch.parallel.datagen import GridSpec, build_lattice
from irbfn_tpu_torch.solvers.qp import (double_integrator_mpc,
                                        solve_linear_mpc_batch)
from irbfn_tpu_torch.train.checkpoints import save_checkpoint, save_config
from irbfn_tpu_torch.train.trainer import (create_trainer, make_train_step,
                                           pred_l1_loss,
                                           region_spec_from_table)

T_ROLLOUT = 80  # closed-loop steps (8 s at dt 0.1)
MPC_LOOP_ITERS = 400  # ADMM sweeps of each re-solve in the loop
SETTLE_M = 0.1  # a rollout settles when it ends within this of the origin


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--n_grid", type=int, default=9,
                   help="lattice points per state dim")
    p.add_argument("--horizon", type=int, default=10)
    p.add_argument("--epochs", type=int, default=0,
                   help="Adam fine-tune epochs after the closed-form fit "
                        "(at lr 1e-4; full-batch steps at lr 3e-3 destroy "
                        "the per-region closed-form solution). With "
                        "--no_direct_fit this is the whole training run.")
    p.add_argument("--no_direct_fit", action="store_true",
                   help="reference-parity mode: Adam from scratch, no "
                        "closed-form solve")
    p.add_argument("--num_k", type=int, default=256)
    p.add_argument("--splits", type=int, default=2,
                   help="region segments per state dim for the direct fit "
                        "(splits^4 per-region output heads)")
    p.add_argument("--n_extra", type=int, default=32768,
                   help="extra near-origin gaussian-sampled solves appended "
                        "to the lattice (regulation accuracy lives there)")
    p.add_argument("--save_path", type=str, default="torch_runs",
                   help="directory of the table, results and figure")
    p.add_argument("--run_name", type=str, default="quadrotor_pr")
    p.add_argument("--n_test", type=int, default=4096)
    p.add_argument("--n_rollout", type=int, default=64)
    p.add_argument("--out_dir", type=str, default="torch_runs",
                   help="directory of <run_name>.json and its checkpoint")
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: the card)")
    args = p.parse_args(argv)
    if args.no_direct_fit and args.epochs == 0:
        p.error("--no_direct_fit trains with Adam from scratch; --epochs "
                "must be > 0 (the reference uses 300) or the saved net is "
                "random init")
    return args


def lattice(n_grid: int, n_extra: int):
    """Start states [px, py, vx, vy]: ``(grid, rows)``, the rows being the
    grid and ``n_extra`` seeded near-origin gaussian rows (a uniform lattice
    spends under 1% of its rows inside the settling ball)."""
    grid = (GridSpec("px", -3.0, 3.0, n_grid),
            GridSpec("py", -3.0, 3.0, n_grid),
            GridSpec("vx", -2.0, 2.0, n_grid),
            GridSpec("vy", -2.0, 2.0, n_grid))
    x_lat = build_lattice(grid, dtype=np.float32)
    rng0 = np.random.default_rng(2)
    x_ext = np.clip(
        rng0.normal(0.0, [1.2, 1.2, 0.8, 0.8], (n_extra, 4)),
        [-3, -3, -2, -2], [3, 3, 2, 2]).astype(np.float32)
    return x_lat, np.concatenate([x_lat, x_ext], axis=0)


def eval_states(n_test: int, n_rollout: int):
    """The off-grid test states and the closed loop's ring of starts, from
    one seeded generator in the script's order."""
    rng = np.random.default_rng(1)
    x_test = rng.uniform([-3, -3, -2, -2], [3, 3, 2, 2],
                         (n_test, 4)).astype(np.float32)
    ang = np.linspace(0, 2 * np.pi, n_rollout, endpoint=False)
    starts = np.stack([2.5 * np.cos(ang), 2.5 * np.sin(ang),
                       rng.uniform(-1, 1, n_rollout),
                       rng.uniform(-1, 1, n_rollout)],
                      axis=1).astype(np.float32)
    return x_test, starts


@torch.no_grad()
def roll_net(model, mpc, x, steps: int = T_ROLLOUT) -> torch.Tensor:
    """The net in the loop: ``steps`` x (one forward, clipped controls, one
    linear step). Returns the states after each step (steps, B, 4)."""
    out = []
    for _ in range(steps):
        u = torch.minimum(torch.maximum(model(x), mpc.u_lo), mpc.u_hi)
        x = x @ mpc.Ad.T + u @ mpc.Bd.T
        out.append(x)
    return torch.stack(out)


def roll_mpc(mpc, x, steps: int = T_ROLLOUT,
             iters: int = MPC_LOOP_ITERS) -> torch.Tensor:
    """The MPC re-solved every step (``iters`` sweeps at most); (steps, B,
    4)."""
    goal = torch.zeros_like(x)
    out = []
    for _ in range(steps):
        u = solve_linear_mpc_batch(mpc, x, goal, iters=iters)[0][:, 0]
        x = x @ mpc.Ad.T + u @ mpc.Bd.T
        out.append(x)
    return torch.stack(out)


def regulation(tr_net: np.ndarray, tr_mpc: np.ndarray) -> dict:
    d_net = np.linalg.norm(tr_net[:, :, :2], axis=2)  # (T, n)
    d_mpc = np.linalg.norm(tr_mpc[:, :, :2], axis=2)
    return {"final_dist_net": float(d_net[-1].mean()),
            "final_dist_mpc": float(d_mpc[-1].mean()),
            "settle_frac_net": float((d_net[-1] < SETTLE_M).mean()),
            "settle_frac_mpc": float((d_mpc[-1] < SETTLE_M).mean())}


def run(args: argparse.Namespace, device=None) -> dict:
    """Lattice, solve, fit, save, off-grid eval and both closed loops;
    writes the table, the config and checkpoint, and the results JSON.
    Returns the results with the seconds of each part and the
    trajectories."""
    device = resolve_device(device)
    seconds = {}
    t0 = wait_clock(device)
    x_lat, x0 = lattice(args.n_grid, args.n_extra)
    print(f"lattice: {x_lat.shape[0]:,} + {args.n_extra:,} near-origin "
          "MPC problems")

    mpc = double_integrator_mpc(horizon=args.horizon, device=device)
    x0_dev = torch.as_tensor(x0).to(device)
    seconds["lattice"] = wait_clock(device) - t0
    t0 = wait_clock(device)
    controls, sol = solve_linear_mpc_batch(mpc, x0_dev,
                                           torch.zeros_like(x0_dev))
    seconds["solve"] = wait_clock(device) - t0
    controls = controls.cpu().numpy()
    converged = sol.converged.cpu().numpy()
    sweeps = min(int(sol.iterations.max()) + 1, 1000)  # the solve's cap
    solve = dict(rate=x0.shape[0] / seconds["solve"],
                 converged=float(converged.mean()), sweeps=sweeps)
    print(f"{solve['rate']:,.0f} QP solves/s; {solve['converged']:.1%} "
          "converged")

    # fit (state) -> first control [ax, ay]. The solution map is odd (the
    # box is symmetric), so every row is mirrored; rows near the origin are
    # weighted up on top of the near-origin rows
    t0 = wait_clock(device)
    y = controls[:, 0]
    x_fit = np.concatenate([x0, -x0], axis=0)
    y_fit = np.concatenate([y, -y], axis=0)
    if args.no_direct_fit:
        x_fit, y_fit = x0, y
        input_scale = None
        head_mode = "shared"
        lower_bounds, upper_bounds = [[-3.5]], [[3.5]]
        dimension_ranges, activation_idx, delta = [[0]], [0], [5.0]
    else:
        input_scale = tuple(float(s) for s in data_scale(x_fit))
        head_mode = "per_region"
        lower_bounds, upper_bounds, dimension_ranges, delta = (
            region_spec_from_table(x_lat, [args.splits] * 4))
        activation_idx = [0, 1, 2, 3]
    num_regions = len(dimension_ranges)
    model = WCRBFNet(
        in_features=4, out_features=2, num_kernels=args.num_k,
        basis_func="gaussian_wide", num_regions=num_regions,
        lower_bounds=lower_bounds, upper_bounds=upper_bounds,
        dimension_ranges=dimension_ranges, activation_idx=activation_idx,
        delta=delta, input_scale=input_scale, head_mode=head_mode,
        device=device, seed=0)
    lr = 3e-3 if args.no_direct_fit else 1e-4
    trainer = create_trainer(model, lr=lr)
    xd = torch.as_tensor(x_fit).to(device)
    yd = torch.as_tensor(y_fit).to(device)
    seconds["model"] = wait_clock(device) - t0

    loss = None
    if not args.no_direct_fit:
        lb, ub = build_region_bounds(lower_bounds, upper_bounds,
                                     dimension_ranges, activation_idx)
        w_scale = np.asarray([1.0, 1.0, 0.7, 0.7], np.float32)
        sample_weight = (0.25 + np.exp(
            -0.5 * np.sum((x_fit / w_scale) ** 2, axis=1))).astype(np.float32)
        t0 = wait_clock(device)
        centers, log_sigs = choose_centers(
            x_fit, num_kernels=args.num_k, num_regions=num_regions, seed=0,
            input_scale=input_scale, lb=lb, ub=ub,
            activation_idx=tuple(activation_idx), probs=sample_weight,
            device=device)
        seconds["centers"] = wait_clock(device) - t0
        t0 = wait_clock(device)
        fit = fit_per_region(x_fit, y_fit, centers, log_sigs, lb, ub, delta,
                             tuple(activation_idx), "gaussian_wide",
                             input_scale=input_scale,
                             sample_weight=sample_weight, device=device)
        install_fit(model, fit)
        with torch.no_grad():
            loss = float((model(xd) - yd).abs().mean())
        seconds["fit"] = wait_clock(device) - t0
        print(f"closed-form fit in {seconds['fit']:.1f}s, control L1 "
              f"{loss:.5f}")

    if args.epochs:
        step = make_train_step(pred_l1_loss, None)
        t0 = wait_clock(device)
        for _ in range(args.epochs):
            loss = float(step(trainer, xd, yd).loss)
        seconds["adam"] = wait_clock(device) - t0
        print(f"final control L1 after {args.epochs} Adam epochs: "
              f"{loss:.5f}")
    model.eval()
    t0 = time.perf_counter()
    os.makedirs(args.save_path, exist_ok=True)
    table_path = os.path.join(args.save_path, "quadrotor_table.npz")
    np.savez(table_path, inputs=x0, outputs=y)
    print(f"saved {table_path}")

    config = {
        "model_class": "WCRBFNet", "in_features": 4, "out_features": 2,
        "num_kernels": args.num_k, "basis_func": "gaussian_wide",
        "num_regions": num_regions, "lower_bounds": lower_bounds,
        "upper_bounds": upper_bounds, "dimension_ranges": dimension_ranges,
        "activation_idx": activation_idx, "delta": delta,
        "head_mode": head_mode,
        "input_scale": None if input_scale is None else list(input_scale),
        "epochs": args.epochs, "lr": lr, "seed": 0,
        "pipeline": "quadrotor"}
    config_path = os.path.join(args.out_dir, f"{args.run_name}.json")
    save_config(config_path, config)
    ckpt_dir = os.path.abspath(os.path.join(args.out_dir, args.run_name))
    save_checkpoint(ckpt_dir, model, step=0)
    seconds["save"] = time.perf_counter() - t0

    # off-grid accuracy against fresh solves
    x_test, starts = eval_states(args.n_test, args.n_rollout)
    xt = torch.as_tensor(x_test).to(device)
    t0 = wait_clock(device)
    u_true, sol_t = solve_linear_mpc_batch(mpc, xt, torch.zeros_like(xt))
    with torch.no_grad():
        u_pred = model(xt)
    off_mae = float((u_pred - u_true[:, 0]).abs().mean())
    seconds["off_grid"] = wait_clock(device) - t0
    print(f"off-grid control MAE vs fresh ADMM: {off_mae:.5f} "
          f"({float(sol_t.converged.float().mean()):.1%} solves converged)")

    # closed-loop regulation: the net in the loop against the re-solved MPC
    s_dev = torch.as_tensor(starts).to(device)
    t0 = wait_clock(device)
    tr_net = roll_net(model, mpc, s_dev).cpu().numpy()
    seconds["loop_net"] = wait_clock(device) - t0
    t0 = wait_clock(device)
    tr_mpc = roll_mpc(mpc, s_dev).cpu().numpy()
    seconds["loop_mpc"] = wait_clock(device) - t0
    res = {"train_l1": loss, "off_grid_mae": off_mae,
           **regulation(tr_net, tr_mpc)}
    print(f"closed-loop 8s regulation from r=2.5 ring: final dist "
          f"net {res['final_dist_net']:.4f} m vs re-solved MPC "
          f"{res['final_dist_mpc']:.4f} m; settled(<0.1 m) "
          f"net {res['settle_frac_net']:.0%} / mpc "
          f"{res['settle_frac_mpc']:.0%}")
    res_path = os.path.join(args.save_path, "quadrotor_results.json")
    with open(res_path, "w") as f:
        json.dump(res, f, indent=1)
    print(f"saved {res_path}")
    return dict(results=res, seconds=seconds, solve=solve, controls=controls,
                converged=converged, tr_net=tr_net, tr_mpc=tr_mpc,
                starts=starts, model=model, config_path=config_path,
                ckpt_dir=ckpt_dir)


def plot(out: dict, path: str):
    """The regulation figure: every n/16-th rollout of the net over the
    re-solved MPC's, with the settle ring (imports matplotlib)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    tr_net, tr_mpc, starts = out["tr_net"], out["tr_mpc"], out["starts"]
    n_cl = starts.shape[0]
    fig, ax = plt.subplots(figsize=(6, 6))
    for k in range(0, n_cl, max(n_cl // 16, 1)):
        ax.plot(tr_mpc[:, k, 0], tr_mpc[:, k, 1], color="0.7", lw=1.0,
                zorder=1)
        ax.plot(tr_net[:, k, 0], tr_net[:, k, 1], color="C0", lw=1.0,
                zorder=2)
        ax.plot(starts[k, 0], starts[k, 1], "k.", ms=4, zorder=3)
    ax.plot([], [], color="0.7", label="re-solved MPC")
    ax.plot([], [], color="C0", label="WCRBF net")
    ax.plot([], [], color="C3", lw=1.0, label="0.1 m settle ring")
    ax.add_patch(plt.Circle((0, 0), SETTLE_M, fill=False, color="C3",
                            lw=1.0))
    ax.set_aspect("equal")
    ax.legend(loc="upper right", fontsize=8)
    ax.set_title("quadrotor regulation: net vs re-solved MPC")
    fig.savefig(path, dpi=130, bbox_inches="tight")
    plt.close(fig)
    print(f"saved {path}")


def main(argv=None) -> dict:
    args = parse_args(argv)
    out = run(args, args.device)
    plot(out, os.path.join(args.save_path, "quadrotor_demo.png"))
    return out


if __name__ == "__main__":
    main()
