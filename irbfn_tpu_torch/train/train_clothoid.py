"""Clothoid-LUT trainer: fit a WCRBF net from goal pose (x, y, theta) to
spiral params (k0, k1, k2, k3, s) on a LUT of
``parallel/gen_clothoid_lut.py``.

Port of ``scripts/train_clothoid.py``, with its flags and prints plus
``--device``, ``--out_dir`` and ``--finetune_steps``:

1. overlapping region bounds from the LUT's grid, the closed-form fit
   (``models/fit.py:fit_per_region`` or ``fit_direct``) on the LUT resident
   on the device;
2. ``--error_reweight`` IRLS rounds: the closed-form fit is least squares in
   PARAM space, but the endpoint amplifies long-arc param error ~s^2/2, so
   each round measures every LUT row's endpoint |x| + |y| error (the net's
   forward under ``no_grad``, on the card the fused RBF kernel, then
   ``integrate_endpoint_gl``), and feeds ``w = 1 + gain * err`` back as the
   center-sampling probability and the row weight of a refit;
3. ``--finetune_epochs`` of Adam on ``clothoid_endpoint_loss`` (the module
   path); ``--finetune_steps`` caps the steps in all (0: no cap);
4. the checkpoint, then the strided probes: spiral-param L1 and endpoint xy
   L1 on up to 65,536 strided LUT rows.

Writes ``<out_dir>/<run_name>.json`` (the config) beside
``<out_dir>/<run_name>/step_0.npz``, the pair ``train.load_model`` reads.
``--resume`` skips the closed-form fit and fine-tunes that checkpoint.

Usage: ``python -m irbfn_tpu_torch.train.train_clothoid --lut_path LUT
[--num_x 8 --num_y 4 --num_t 4 --num_k 256 --error_reweight 2
--finetune_epochs 30] [--device cpu]``
"""

from __future__ import annotations

import argparse
import functools
import os

import numpy as np
import torch

from irbfn_tpu_torch._device import resolve_device, wait_clock
from irbfn_tpu_torch.dynamics.spiral import integrate_endpoint_gl
from irbfn_tpu_torch.models import WCRBFNet, build_region_bounds
from irbfn_tpu_torch.models.fit import (choose_centers, data_scale,
                                        device_table, fit_direct,
                                        fit_per_region, install_fit)
from irbfn_tpu_torch.train.checkpoints import (params_from_jax,
                                               restore_params,
                                               save_checkpoint, save_config)
from irbfn_tpu_torch.train.eval_lut_accuracy import load_lut
from irbfn_tpu_torch.train.train_goal_mpc import PROBE_CHUNK, strided_rows
from irbfn_tpu_torch.train.trainer import (clothoid_endpoint_loss,
                                           create_trainer, make_train_step,
                                           region_spec_from_table,
                                           train_epochs)
from irbfn_tpu_torch.utils.args import add_device_args

# rows per forward of the IRLS error pass
ERR_CHUNK = 1 << 16


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--lut_path", type=str, required=True)
    p.add_argument("--run_name", type=str, default="clothoid_pr")
    p.add_argument("--num_k", type=int, default=256)
    p.add_argument("--num_x", type=int, default=4,
                   help="overlapping region segments along x")
    p.add_argument("--num_y", type=int, default=1)
    p.add_argument("--num_t", type=int, default=2)
    p.add_argument("--num_overlap", type=int, default=1)
    p.add_argument("--basis_function", type=str, default="gaussian")
    p.add_argument("--fit_mode", type=str, default="per_region",
                   choices=["shared", "per_region"])
    p.add_argument("--reg", type=float, default=1e-5)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--finetune_epochs", type=int, default=0,
                   help="Adam epochs on the endpoint loss after the "
                        "closed-form fit")
    p.add_argument("--finetune_steps", type=int, default=0,
                   help="cap on the fine-tune's steps in all (0: none)")
    p.add_argument("--error_reweight", type=int, default=0,
                   help="IRLS rounds after the closed-form fit: every row's "
                        "endpoint xy error upweights hard rows "
                        "(w = 1 + gain*err) in the center sampling and the "
                        "refit")
    p.add_argument("--reweight_gain", type=float, default=2.0,
                   help="weight per meter of endpoint error in the IRLS "
                        "rounds")
    p.add_argument("--finetune_lr", type=float, default=1e-4)
    p.add_argument("--batch", type=int, default=8192)
    p.add_argument("--end_weight", type=float, default=4.0)
    p.add_argument("--resume", action="store_true",
                   help="skip the closed-form fit; fine-tune from the "
                        "existing run_name checkpoint")
    add_device_args(p)
    return p.parse_args(argv)


@torch.no_grad()
def endpoint_xy_errors(model, x_dev: torch.Tensor, n_rows: int,
                       chunk: int = ERR_CHUNK) -> np.ndarray:
    """|x| + |y| endpoint error (f32) of the net's spiral for each of the
    first ``n_rows`` rows of the resident LUT."""
    errs = np.empty(n_rows, np.float32)
    for i0 in range(0, n_rows, chunk):
        xb = x_dev[i0:min(i0 + chunk, n_rows)]
        end = integrate_endpoint_gl(model(xb))
        errs[i0:i0 + xb.shape[0]] = (
            (end[:, :2] - xb[:, :2]).abs().sum(dim=1).cpu().numpy())
    return errs


@torch.no_grad()
def strided_probes(model, x_dev, y_dev, n_rows: int):
    """(spiral-param L1, endpoint xy L1, rows) on strided true rows."""
    idx_all = torch.as_tensor(strided_rows(n_rows), device=x_dev.device)
    l1 = torch.zeros((), dtype=torch.float64, device=x_dev.device)
    end_l1 = torch.zeros_like(l1)
    for i0 in range(0, idx_all.numel(), PROBE_CHUNK):
        idx = idx_all[i0:i0 + PROBE_CHUNK]
        pred = model(x_dev[idx])
        l1 += (pred - y_dev[idx]).abs().sum().double()
        end = integrate_endpoint_gl(pred)
        end_l1 += (end[:, :2] - x_dev[idx][:, :2]).abs().sum().double()
    n = idx_all.numel()
    return float(l1) / (n * 5), float(end_l1) / (n * 2), int(n)


def train(args, inputs: np.ndarray, outputs: np.ndarray) -> dict:
    """Everything after the LUT is read. Returns the model, its config and
    paths, the probes, the IRLS rounds' error means and the seconds of each
    part (each ends with a device wait)."""
    device = resolve_device(args.device)
    seconds = {}
    t0 = wait_clock(device)
    splits = [args.num_x, args.num_y, args.num_t]
    lower_bounds, upper_bounds, dimension_ranges, delta = (
        region_spec_from_table(inputs, splits, num_overlap=args.num_overlap))
    num_regions = int(np.prod(splits))
    activation_idx = [0, 1, 2]
    input_scale = tuple(float(v) for v in data_scale(inputs))
    seconds["region_spec"] = wait_clock(device) - t0

    model = WCRBFNet(
        in_features=3, out_features=5, num_kernels=args.num_k,
        basis_func=args.basis_function, num_regions=num_regions,
        lower_bounds=lower_bounds, upper_bounds=upper_bounds,
        dimension_ranges=dimension_ranges, activation_idx=activation_idx,
        delta=delta, input_scale=input_scale, head_mode=args.fit_mode,
        device=device, seed=args.seed)
    config = {
        "model_class": "WCRBFNet", "in_features": 3, "out_features": 5,
        "num_kernels": args.num_k, "basis_func": args.basis_function,
        "num_regions": num_regions, "lower_bounds": lower_bounds,
        "upper_bounds": upper_bounds, "dimension_ranges": dimension_ranges,
        "activation_idx": activation_idx, "delta": delta,
        "seed": args.seed, "input_scale": list(input_scale),
        "head_mode": args.fit_mode,
    }
    config_path = os.path.join(args.out_dir, f"{args.run_name}.json")
    save_config(config_path, config)
    ckpt_dir = os.path.abspath(os.path.join(args.out_dir, args.run_name))

    t0 = wait_clock(device)
    x_dev, y_dev, n_rows = device_table(inputs, outputs, device=device)
    seconds["upload"] = wait_clock(device) - t0
    print(f"table resident on device in {seconds['upload']:.1f}s "
          f"({(x_dev.numel() + y_dev.numel()) * 4 / 2**20:.0f} MB)")
    lb, ub = build_region_bounds(lower_bounds, upper_bounds,
                                 dimension_ranges, activation_idx)

    def fit(seed, probs=None, tag=""):
        t0 = wait_clock(device)
        centers, log_sigs = choose_centers(
            inputs, num_kernels=args.num_k, num_regions=num_regions,
            seed=seed, input_scale=input_scale, lb=lb, ub=ub,
            activation_idx=activation_idx, probs=probs, x_dev=x_dev)
        seconds[f"centers{tag}"] = wait_clock(device) - t0
        t0 = wait_clock(device)
        if args.fit_mode == "per_region":
            res = fit_per_region(inputs, outputs, centers, log_sigs, lb, ub,
                                 delta, tuple(activation_idx),
                                 args.basis_function, reg=args.reg,
                                 input_scale=input_scale,
                                 sample_weight=probs, x_dev=x_dev,
                                 y_dev=y_dev)
        else:
            res = fit_direct(x_dev[:n_rows], y_dev[:n_rows], centers,
                             log_sigs, lb, ub, delta, tuple(activation_idx),
                             args.basis_function, reg=args.reg,
                             input_scale=input_scale, sample_weight=probs)
        install_fit(model, res)
        seconds[f"fit{tag}"] = wait_clock(device) - t0
        return res

    if args.resume:
        model.load_state_dict(params_from_jax(restore_params(ckpt_dir),
                                              config))
        print(f"resumed from {ckpt_dir}")
    else:
        fit(args.seed)
        print(f"direct fit in {seconds['fit']:.1f}s")

    irls = []
    for rnd in range(args.error_reweight):
        # IRLS on the endpoint metric: uniform rows starve the long-chord
        # corner of both kernels and fit pressure
        t0 = wait_clock(device)
        errs = endpoint_xy_errors(model, x_dev, n_rows)
        seconds[f"errors_{rnd + 1}"] = wait_clock(device) - t0
        irls.append(float(errs.mean()))
        print(f"  IRLS round {rnd + 1}: endpoint |x|+|y| err mean "
              f"{errs.mean():.4f}  p99.9 {np.percentile(errs, 99.9):.3f}"
              f"  max {errs.max():.3f}; reweighting", flush=True)
        w = (1.0 + args.reweight_gain * errs).astype(np.float32)
        fit(args.seed + rnd + 1, probs=w, tag=f"_{rnd + 1}")

    if args.finetune_epochs > 0:
        steps_per_epoch = max(1, n_rows // args.batch)
        trainer = create_trainer(
            model, lr=args.finetune_lr,
            decay_steps=args.finetune_epochs * steps_per_epoch)
        loss = functools.partial(clothoid_endpoint_loss,
                                 end_weight=args.end_weight)
        t0 = wait_clock(device)
        train_epochs(
            trainer, make_train_step(loss, None), x_dev[:n_rows],
            y_dev[:n_rows], batch_size=args.batch,
            epochs=args.finetune_epochs, seed=args.seed,
            log_fn=lambda s, m: print(
                f"  step {s}: loss {float(m.loss):.4f} "
                f"param {float(m.pred_loss):.4f} "
                f"endpoint {float(m.int_loss):.4f}", flush=True),
            log_every=200, max_steps=args.finetune_steps or None)
        seconds["finetune"] = wait_clock(device) - t0
        print(f"fine-tuned {args.finetune_epochs} epochs "
              f"in {seconds['finetune']:.1f}s")

    save_checkpoint(ckpt_dir, model, step=0)
    print(f"checkpoint at {ckpt_dir}")

    t0 = wait_clock(device)
    l1, end_l1, n_seen = strided_probes(model, x_dev, y_dev, n_rows)
    seconds["probes"] = wait_clock(device) - t0
    print(f"spiral-param L1 {l1:.5f}  endpoint xy L1 {end_l1:.5f} "
          f"(on {n_seen:,} strided rows)")
    return dict(model=model, config=config, config_path=config_path,
                ckpt_dir=ckpt_dir, param_l1=l1, endpoint_l1=end_l1,
                irls_err_means=irls, seconds=seconds)


def main(argv=None) -> dict:
    args = parse_args(argv)
    data = load_lut(args.lut_path)
    inputs = data["goals"].astype(np.float32)
    print(f"{inputs.shape[0]:,} LUT rows "
          f"({'x'.join(str(n) for n in data['lut'].shape[:3])})")
    return train(args, inputs, data["params"].astype(np.float32))


if __name__ == "__main__":
    main()
