"""Goal-MPC net evaluation: table accuracy, and OFF-GRID generalisation
where the truth is a fresh batched ADMM solve (one launch of the ADMM
kernel for all the off-grid rows).

Port of ``scripts/eval_goal_mpc.py``, with its flags and prints.

Usage: ``python -m irbfn_tpu_torch.train.eval_goal_mpc --config_f RUN.json
--ckpt RUN_DIR_OR_NPZ --npz_path TABLE [--n_offgrid 4096] [--device cpu]``
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from irbfn_tpu_torch._device import resolve_device
from irbfn_tpu_torch.solvers.goal_mpc import solve_goal_mpc
from irbfn_tpu_torch.train.checkpoints import load_model
from irbfn_tpu_torch.train.train_goal_mpc import (PROBE_CHUNK, load_table,
                                                  strided_rows)

OFFGRID_ITERS = 1200  # sweeps of the off-grid truth


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--config_f", type=str, required=True)
    p.add_argument("--ckpt", type=str, required=True)
    p.add_argument("--npz_path", type=str, required=True)
    p.add_argument("--n_offgrid", type=int, default=4096)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: the card)")
    return p.parse_args(argv)


@torch.no_grad()
def evaluate(model, inputs: np.ndarray, outputs: np.ndarray, lows, highs,
             n_offgrid: int = 4096, seed: int = 0, device=None) -> dict:
    """Table MAE on strided converged rows and off-grid MAE against
    ``solve_goal_mpc(..., iters=1200)`` on uniform random rows inside the
    lattice box (converged rows only). Prints both lines."""
    device = resolve_device(device)
    idx = strided_rows(inputs.shape[0])
    ae = np.zeros(2)
    for i0 in range(0, idx.size, PROBE_CHUNK):
        blk = idx[i0:i0 + PROBE_CHUNK]
        pred = model(torch.as_tensor(inputs[blk]).to(device)).cpu().numpy()
        ae += np.abs(pred - outputs[blk]).sum(axis=0)
    table_mae = ae / idx.size
    print(f"table:    speed MAE {table_mae[0]:.4f} m/s, "
          f"steer MAE {table_mae[1]:.4f} rad ({idx.size:,} rows)")

    rng = np.random.default_rng(seed)
    off = rng.uniform(lows, highs, (n_offgrid, len(lows))).astype(np.float32)
    off_dev = torch.as_tensor(off).to(device)
    truth = solve_goal_mpc(off_dev, iters=OFFGRID_ITERS)
    keep = truth.converged.cpu().numpy()
    y_true = torch.stack([truth.speed, truth.steer], dim=1).cpu().numpy()
    pred = model(off_dev).cpu().numpy()
    mae = np.abs(pred[keep] - y_true[keep]).mean(axis=0)
    print(f"off-grid: speed MAE {mae[0]:.4f} m/s, "
          f"steer MAE {mae[1]:.4f} rad ({int(keep.sum()):,} rows vs "
          "fresh ADMM truth)")
    return dict(table_mae=table_mae, offgrid_mae=mae,
                n_table=int(idx.size), n_offgrid=int(keep.sum()), off=off)


def main(argv=None) -> dict:
    args = parse_args(argv)
    model, _ = load_model(args.config_f, args.ckpt, device=args.device)
    model.eval()
    inputs, outputs = load_table(args.npz_path)
    with np.load(args.npz_path) as data:
        lows, highs = data["lows"], data["highs"]
    return evaluate(model, inputs, outputs, lows, highs, args.n_offgrid,
                    args.seed, device=args.device)


if __name__ == "__main__":
    main()
