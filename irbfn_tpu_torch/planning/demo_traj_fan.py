"""Trajectory-fan figure: map a fan of goal poses to spirals, integrate
them, and plot every trajectory.

Port of ``scripts/demo_traj_fan.py``, with its flags, plus ``--device``.
The goal -> spiral map is the exact clothoid solver, or with ``--config_f``
/ ``--ckpt`` a trained net (``clothoid_pr``): one forward of the 450
goals, on the card one ``rbf_forward`` kernel launch.

``run(args)`` computes the fan; ``draw`` plots it (matplotlib).

Usage: ``python -m irbfn_tpu_torch.planning.demo_traj_fan [--config_f
irbfn_tpu_torch/assets/clothoid_pr.json --ckpt
irbfn_tpu_torch/assets/clothoid_pr.npz] [--out torch_runs/traj_out.png]
[--device cpu]``
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from irbfn_tpu_torch._device import resolve_device
from irbfn_tpu_torch.dynamics.spiral import sample_path
from irbfn_tpu_torch.solvers.clothoid import solve_g1_lattice


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--out", type=str, default="torch_runs/traj_out.png")
    p.add_argument("--config_f", type=str, default=None)
    p.add_argument("--ckpt", type=str, default=None)
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: the card)")
    return p.parse_args(argv)


def fan_goals() -> np.ndarray:
    """The 6 x 15 x 5 = 450 goals (x, y, theta), 'ij' order, f32."""
    xs = np.linspace(8.0, 25.0, 6)
    ys = np.linspace(-7.0, 7.0, 15)
    ts = np.linspace(-1.2, 1.2, 5)
    X, Y, T = np.meshgrid(xs, ys, ts, indexing="ij")
    return np.stack([X, Y, T], axis=-1).reshape(-1, 3).astype(np.float32)


def run(args) -> dict:
    """The fan's spiral parameters and paths (450, 32, 4)."""
    device = resolve_device(args.device)
    goals = torch.as_tensor(fan_goals()).to(device)
    if args.config_f:
        from irbfn_tpu_torch.train import load_model

        model = load_model(args.config_f, args.ckpt, device=device)[0].eval()
        with torch.no_grad():
            params = model(goals)
        label = "net"
    else:
        params = solve_g1_lattice(goals)
        label = "solver"
    paths = sample_path(params, n_points=32)
    return dict(goals=goals, params=params, paths=paths, label=label)


def draw(out: dict, path: str):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    goals = out["goals"].cpu().numpy()
    fig, ax = plt.subplots(figsize=(8, 6))
    for traj in out["paths"].cpu().numpy():
        ax.plot(traj[:, 0], traj[:, 1], lw=0.4, alpha=0.5, color="tab:blue")
    ax.plot(goals[:, 0], goals[:, 1], ".", ms=2, color="tab:red",
            label="goals")
    ax.set_aspect("equal")
    ax.set_title(f"clothoid trajectory fan ({out['label']}, "
                 f"{goals.shape[0]} goals)")
    ax.legend()
    fig.tight_layout()
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    fig.savefig(path, dpi=150)
    plt.close(fig)
    print(f"saved {path}")


def main(argv=None) -> dict:
    args = parse_args(argv)
    out = run(args)
    draw(out, args.out)
    return out


if __name__ == "__main__":
    main()
