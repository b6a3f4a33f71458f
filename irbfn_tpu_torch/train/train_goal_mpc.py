"""Goal-MPC net trainer: fit a WCRBF net mapping (v_car, x_goal, y_goal,
t_goal, v_goal) -> (speed, steer) on a table made by
``python -m irbfn_tpu_torch.parallel.gen_goal_mpc_table``.

Port of ``scripts/train_goal_mpc.py``, with its flags and prints. The
anisotropic ``input_scale`` metric takes the place of input normalisation
and the closed-form per-region fit (``models/fit.py``) the place of Adam
epochs, with an optional L1 fine-tune (``--finetune_epochs``). The table
goes to the device once; the box tests, the gram passes and the solves run
there.

Writes ``<out_dir>/<run_name>.json`` (the config) and
``<out_dir>/<run_name>/step_0.npz`` (the weights): the pair
``train.load_model`` and ``eval_goal_mpc`` take.

Usage: ``python -m irbfn_tpu_torch.train.train_goal_mpc --npz_path TABLE
[--num_k 512 --num_v_car 2 --num_x_goal 2 --num_t_goal 2 --num_v_goal 2]
[--device cpu]``
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from irbfn_tpu_torch._device import resolve_device, wait_clock
from irbfn_tpu_torch.models import WCRBFNet, build_region_bounds
from irbfn_tpu_torch.models.fit import (choose_centers, data_scale,
                                        device_table, fit_direct,
                                        fit_per_region, install_fit)
from irbfn_tpu_torch.train.checkpoints import save_checkpoint, save_config
from irbfn_tpu_torch.train.trainer import (create_trainer, make_train_step,
                                           pred_l1_loss,
                                           region_spec_from_table,
                                           train_epochs)
from irbfn_tpu_torch.utils.args import add_device_args

DIMS = ["v_car", "x_goal", "y_goal", "t_goal", "v_goal"]
PROBE_ROWS = 65536  # strided rows of the MAE probe
PROBE_CHUNK = 8192


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--npz_path", type=str, required=True)
    p.add_argument("--run_name", type=str, default="goal_mpc_pr")
    p.add_argument("--num_k", type=int, default=256)
    for d in DIMS:
        p.add_argument(f"--num_{d}", type=int, default=1,
                       help=f"region splits along {d}")
    p.add_argument("--num_overlap", type=int, default=1)
    p.add_argument("--basis_function", type=str, default="inverse_quadratic")
    p.add_argument("--fit_mode", type=str, default="per_region",
                   choices=["shared", "per_region"])
    p.add_argument("--reg", type=float, default=1e-5)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--finetune_epochs", type=int, default=0)
    p.add_argument("--finetune_lr", type=float, default=1e-4)
    p.add_argument("--batch", type=int, default=8192)
    add_device_args(p)
    return p.parse_args(argv)


def load_table(npz_path: str):
    """(inputs, outputs) of a goal-MPC table's converged rows, f32."""
    with np.load(npz_path) as data:
        valid = data["valid"]
        return (data["inputs"].astype(np.float32)[valid],
                data["outputs"].astype(np.float32)[valid])


def strided_rows(n_rows: int, n_probe: int = PROBE_ROWS) -> np.ndarray:
    """Up to ``n_probe`` row indices spread over a table of ``n_rows``."""
    n_probe = min(n_probe, n_rows)
    stride = max(n_rows // n_probe, 1)
    return np.arange(0, n_rows, stride)[:n_probe]


@torch.no_grad()
def strided_mae(model, x_dev, y_dev, n_rows: int):
    """Per-output mean |error| of ``model`` on strided true rows of the
    resident table (its tail is zero padding), in chunks: (mae, rows)."""
    idx_all = torch.as_tensor(strided_rows(n_rows), device=x_dev.device)
    ae_sum = torch.zeros((y_dev.shape[1],), dtype=torch.float64,
                         device=x_dev.device)
    for i0 in range(0, idx_all.numel(), PROBE_CHUNK):
        idx = idx_all[i0:i0 + PROBE_CHUNK]
        pred = model(x_dev[idx])
        ae_sum += (pred - y_dev[idx]).abs().sum(dim=0).double()
    return (ae_sum / idx_all.numel()).cpu().numpy(), int(idx_all.numel())


def train(args, inputs: np.ndarray, outputs: np.ndarray) -> dict:
    """Everything after the table is read: region spec, centers, the fit,
    the optional fine-tune, the checkpoint and the strided probe. Returns
    the model, its config, the probe's MAE and the seconds of each part."""
    device = resolve_device(args.device)
    print(f"{inputs.shape[0]:,} converged rows")
    seconds = {}

    splits = [getattr(args, f"num_{d}") for d in DIMS]
    t0 = time.perf_counter()
    lower_bounds, upper_bounds, dimension_ranges, delta = (
        region_spec_from_table(inputs, splits, num_overlap=args.num_overlap))
    num_regions = int(np.prod(splits))
    activation_idx = list(range(5))
    input_scale = tuple(float(v) for v in data_scale(inputs))
    seconds["region_spec"] = time.perf_counter() - t0

    config = {
        "model_class": "WCRBFNet", "in_features": 5, "out_features": 2,
        "num_kernels": args.num_k, "basis_func": args.basis_function,
        "num_regions": num_regions, "lower_bounds": lower_bounds,
        "upper_bounds": upper_bounds, "dimension_ranges": dimension_ranges,
        "activation_idx": activation_idx, "delta": delta,
        "seed": args.seed, "input_scale": list(input_scale),
        "head_mode": args.fit_mode,
    }
    model = WCRBFNet(
        in_features=5, out_features=2, num_kernels=args.num_k,
        basis_func=args.basis_function, num_regions=num_regions,
        lower_bounds=lower_bounds, upper_bounds=upper_bounds,
        dimension_ranges=dimension_ranges, activation_idx=activation_idx,
        delta=delta, input_scale=input_scale, head_mode=args.fit_mode,
        device=device, seed=args.seed)
    config_path = os.path.join(args.out_dir, f"{args.run_name}.json")
    save_config(config_path, config)
    ckpt_dir = os.path.abspath(os.path.join(args.out_dir, args.run_name))

    t0 = wait_clock(device)
    x_dev, y_dev, n_rows = device_table(inputs, outputs, device=device)
    seconds["upload"] = wait_clock(device) - t0
    mb = (x_dev.numel() + y_dev.numel()) * 4 / 2**20
    print(f"table resident on device in {seconds['upload']:.1f}s "
          f"({mb:.0f} MB)")
    lb, ub = build_region_bounds(lower_bounds, upper_bounds,
                                 dimension_ranges, activation_idx)
    t0 = wait_clock(device)
    centers, log_sigs = choose_centers(
        inputs, num_kernels=args.num_k, num_regions=num_regions,
        seed=args.seed, input_scale=input_scale, lb=lb, ub=ub,
        activation_idx=activation_idx, x_dev=x_dev)
    seconds["choose_centers"] = wait_clock(device) - t0
    t0 = wait_clock(device)
    if args.fit_mode == "per_region":
        parts = {}
        fit = fit_per_region(inputs, outputs, centers, log_sigs, lb, ub,
                             delta, tuple(activation_idx),
                             args.basis_function, reg=args.reg,
                             input_scale=input_scale, x_dev=x_dev,
                             y_dev=y_dev, timings=parts)
        seconds.update(parts)
    else:
        fit = fit_direct(x_dev[:n_rows], y_dev[:n_rows], centers, log_sigs,
                         lb, ub, delta, tuple(activation_idx),
                         args.basis_function, reg=args.reg,
                         input_scale=input_scale)
    seconds["fit"] = wait_clock(device) - t0
    print(f"direct fit in {seconds['fit']:.1f}s"
          + (f" (box tests {seconds['mask']:.2f}s, gram passes "
             f"{seconds['gram']:.2f}s over {seconds['row_visits']:,} row "
             f"visits, solves {seconds['solve']:.2f}s; region spec and "
             f"input scale {seconds['region_spec']:.2f}s, centers "
             f"{seconds['choose_centers']:.2f}s)"
             if args.fit_mode == "per_region" else ""))
    install_fit(model, fit)

    if args.finetune_epochs > 0:
        steps_per_epoch = max(1, n_rows // args.batch)
        trainer = create_trainer(
            model, lr=args.finetune_lr,
            decay_steps=args.finetune_epochs * steps_per_epoch)
        t0 = wait_clock(device)
        train_epochs(
            trainer, make_train_step(pred_l1_loss, None), x_dev[:n_rows],
            y_dev[:n_rows], batch_size=args.batch,
            epochs=args.finetune_epochs, seed=args.seed,
            log_fn=lambda s, m: print(
                f"  step {s}: L1 {float(m.loss):.4f}", flush=True),
            log_every=200)
        seconds["finetune"] = wait_clock(device) - t0
        print(f"fine-tuned {args.finetune_epochs} epochs "
              f"in {seconds['finetune']:.1f}s")

    save_checkpoint(ckpt_dir, model, step=0)
    print(f"checkpoint at {ckpt_dir}")

    mae, n_seen = strided_mae(model, x_dev, y_dev, n_rows)
    print(f"speed MAE {mae[0]:.4f} m/s, "
          f"steer MAE {mae[1]:.4f} rad "
          f"(on {n_seen:,} strided rows)")
    return dict(model=model, config=config, config_path=config_path,
                ckpt_dir=ckpt_dir, mae=mae, n_probe=n_seen, seconds=seconds,
                x_dev=x_dev, y_dev=y_dev, n_rows=n_rows)


def main(argv=None) -> dict:
    args = parse_args(argv)
    inputs, outputs = load_table(args.npz_path)
    return train(args, inputs, outputs)


if __name__ == "__main__":
    main()
