"""Centralized CLI flag groups for the port's entry points: vehicle,
training, eval and io flags. Port of ``irbfn_tpu/utils/args.py``, with the
same flags and defaults, plus ``add_device_args`` (where an entry point
runs and where it writes)."""

from __future__ import annotations

import argparse


def add_frenet_grid_args(p: argparse.ArgumentParser):
    """8-D Frenet lattice flags, the reference defaults."""
    g = p.add_argument_group("frenet grid")
    for name, lo, hi, num in [
        ("ey", -0.2, 2.0, 12), ("delta", -0.3, 0.3, 7),
        ("vx_car", 1.0, 7.0, 11), ("vy_car", -1.0, 1.0, 11),
        ("vx_goal", 3.0, 7.0, 5), ("wz", -2.6, 2.6, 11),
        ("epsi", -1.0, 1.0, 11), ("curv", -0.1, 0.1, 3),
    ]:
        g.add_argument(f"--{name}_min", type=float, default=lo)
        g.add_argument(f"--{name}_max", type=float, default=hi)
        g.add_argument(f"--num_{name}", type=int, default=num)
    return p


def add_clothoid_grid_args(p: argparse.ArgumentParser):
    """Clothoid goal-lattice flags: x, y, theta ranges and steps (the
    reference's defaults: 251 x 161 x 158 = 6,384,938 goals)."""
    g = p.add_argument_group("clothoid grid")
    g.add_argument("--minx", type=float, default=5.0)
    g.add_argument("--maxx", type=float, default=30.0)
    g.add_argument("--dx", type=float, default=0.1)
    g.add_argument("--miny", type=float, default=-8.0)
    g.add_argument("--maxy", type=float, default=8.0)
    g.add_argument("--dy", type=float, default=0.1)
    g.add_argument("--mint", type=float, default=-1.57)
    g.add_argument("--maxt", type=float, default=1.57)
    g.add_argument("--dt", type=float, default=0.02)
    return p


def add_vehicle_args(p: argparse.ArgumentParser):
    g = p.add_argument_group("vehicle")
    g.add_argument("--mu", type=float, default=1.0)
    g.add_argument("--cs", type=float, default=5.0)
    g.add_argument("--mu_min", type=float, default=None)
    g.add_argument("--mu_max", type=float, default=None)
    g.add_argument("--d_mu", type=float, default=0.1)
    return p


def add_train_args(p: argparse.ArgumentParser):
    """Training flags, the reference defaults."""
    g = p.add_argument_group("training")
    g.add_argument("--npz_path", type=str, required=True)
    g.add_argument("--mirror_data", action="store_true")
    g.add_argument("--only_onestep", action="store_true")
    g.add_argument("--basis_function", type=str, default="gaussian")
    g.add_argument("--deeper", action="store_true")
    g.add_argument("--mlp", action="store_true")
    g.add_argument("--use_cluster", action="store_true")
    g.add_argument("--num_clusters", type=int, default=499)
    g.add_argument("--use_centers", action="store_true")
    g.add_argument("--fixed_centers", action="store_true")
    g.add_argument("--fixed_width", action="store_true")
    g.add_argument("--centers_name", type=str, default="_top500mode")
    g.add_argument("--seed", type=int, default=123)
    g.add_argument("--lr", type=float, default=1e-3)
    g.add_argument("--max_grad_norm", type=float, default=1.0)
    g.add_argument("--batch_size", type=int, default=80000)
    g.add_argument("--num_k", type=int, default=100)
    g.add_argument("--train_epochs", type=int, default=10000)
    g.add_argument("--run_name", type=str, default="dnmpc_tpu")
    g.add_argument("--direct_fit", action="store_true",
                   help="closed-form Cholesky fit instead of Adam")
    g.add_argument("--finetune_epochs", type=int, default=0,
                   help="with --direct_fit: SGD epochs of the integration "
                        "loss from the closed-form warm start")
    g.add_argument("--fit_mode", choices=["shared", "per_region"],
                   default="shared",
                   help="head parameterization: one shared linear head over "
                        "blended features, or per-region local heads over a "
                        "normalized (partition-of-unity) blend")
    g.add_argument("--tube_npz", type=str, default=None,
                   help="npz of closed-loop visited net-input states "
                        "(key \"states\"); weights "
                        "the fit and the kernel-center sampling toward the "
                        "operating tube")
    g.add_argument("--tube_bandwidth", type=float, default=1.0,
                   help="tube-weight kernel bandwidth in input_scale units")
    g.add_argument("--tube_floor", type=float, default=0.05,
                   help="minimum weight for off-tube rows")
    # region splits per dim (num_<dim> regions)
    for name in ("ey", "delta", "vx_car", "vy_car", "vx_goal", "wz",
                 "epsi", "curv"):
        g.add_argument(f"--num_{name}", type=int, default=1)
    return p


def add_eval_args(p: argparse.ArgumentParser):
    """Closed-loop robustness sweep flags."""
    g = p.add_argument_group("eval")
    g.add_argument("--num_trials", type=int, default=10)
    g.add_argument("--num_mu", type=int, default=10)
    g.add_argument("--mu_min", type=float, default=0.5)
    g.add_argument("--mu_max", type=float, default=1.1)
    g.add_argument("--num_cs", type=int, default=10)
    g.add_argument("--cs_min", type=float, default=1.0)
    g.add_argument("--cs_max", type=float, default=10.0)
    g.add_argument("--out_name", type=str, default="eval_results")
    g.add_argument("--noise_scale", type=float, default=0.01)
    g.add_argument("--seed", type=int, default=123)
    g.add_argument("--n_steps", type=int, default=600)
    return p


def add_io_args(p: argparse.ArgumentParser):
    g = p.add_argument_group("io")
    g.add_argument("--save_path", type=str, default="./data/")
    g.add_argument("--run_tag", type=str, default="")
    return p


def add_device_args(p: argparse.ArgumentParser, out_dir: str = "torch_runs"):
    """Where an entry point runs, and where it writes its run: the config
    ``<out_dir>/<run_name>.json`` beside the checkpoint directory
    ``<out_dir>/<run_name>/`` (the pair ``train.load_model`` takes)."""
    g = p.add_argument_group("device and output")
    g.add_argument("--device", type=str, default=None,
                   help="torch device (default: the card)")
    g.add_argument("--out_dir", type=str, default=out_dir)
    return p
