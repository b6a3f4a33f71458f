"""Cartesian trainer: load a cartesian NMPC table
(``parallel/gen_nmpc_table_cartesian.py``), drop the infeasible rows,
optionally mirror it, and fit a WCRBF net: in closed form with
``--direct_fit`` (shared or per-region heads) and/or by Adam on the
full-rollout integration loss (``cartesian_fullint_loss``).

Port of ``scripts/train_cartesian.py``, with its flags and prints plus
``--device`` and ``--out_dir``. Writes ``<out_dir>/<run_name>.json`` beside
``<out_dir>/<run_name>/step_<n>.npz``, the pair ``IRBFNPlanner`` loads
through ``train.load_model`` (``eval_closed_loop --planner irbfn_cart``).
The recipe of the committed ``cart_c1_pr``: ``--direct_fit --fit_mode
per_region --num_k 512 --num_t_goal 4 --num_v_car 2 --num_angv_z 2``.

Usage: ``python -m irbfn_tpu_torch.train.train_cartesian --npz_path TABLE
[--direct_fit --fit_mode per_region] [--finetune_epochs N] [--device cpu]``
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from irbfn_tpu_torch._device import resolve_device, wait_clock
from irbfn_tpu_torch.dynamics.params import f1tenth_params
from irbfn_tpu_torch.models import WCRBFNet, build_region_bounds
from irbfn_tpu_torch.models.fit import (choose_centers, data_scale,
                                        device_table, fit_direct,
                                        fit_per_region, install_fit)
from irbfn_tpu_torch.train.checkpoints import save_checkpoint, save_config
from irbfn_tpu_torch.train.train_goal_mpc import PROBE_CHUNK, strided_rows
from irbfn_tpu_torch.train.trainer import (cartesian_fullint_loss,
                                           create_trainer, make_train_step,
                                           mirror_cartesian_table,
                                           key_seed,
                                           region_spec_from_table,
                                           train_epochs)
from irbfn_tpu_torch.utils import prng
from irbfn_tpu_torch.utils.args import add_device_args
from irbfn_tpu_torch.utils.metrics import MetricLogger

DIMS = ["v_car", "x_goal", "y_goal", "t_goal", "v_goal", "beta", "angv_z"]


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--npz_path", type=str, required=True)
    p.add_argument("--mirror_data", action="store_true")
    p.add_argument("--basis_function", type=str, default="gaussian")
    p.add_argument("--num_k", type=int, default=256)
    p.add_argument("--seed", type=int, default=123)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--max_grad_norm", type=float, default=1.0)
    p.add_argument("--batch_size", type=int, default=80000)
    p.add_argument("--train_epochs", type=int, default=0)
    p.add_argument("--run_name", type=str, default="dnmpc_cart_tpu")
    p.add_argument("--direct_fit", action="store_true")
    p.add_argument("--fit_mode", choices=["shared", "per_region"],
                   default="shared")
    p.add_argument("--finetune_epochs", type=int, default=0)
    p.add_argument("--mu", type=float, default=1.0)
    p.add_argument("--cs", type=float, default=5.0)
    for name in DIMS:
        p.add_argument(f"--num_{name}", type=int, default=1)
    add_device_args(p)
    return p.parse_args(argv)


def load_table(npz_path: str):
    """(inputs, outputs) of a cartesian table's feasible rows."""
    with np.load(npz_path) as data:
        inputs, outputs = data["inputs"], data["outputs"]
    valid = ~np.any(outputs == -999.0, axis=1)
    return inputs[valid], outputs[valid]


def _direct_fit(args, model, config, inputs, outputs, device):
    """Centers, the closed-form fit, the checkpoint (step 0), then the
    strided control-L1 probe. Returns the probe's L1."""
    act = config["activation_idx"]
    input_scale = tuple(config["input_scale"])
    x_dev, y_dev, n_rows = device_table(inputs, outputs, device=device)
    lb, ub = build_region_bounds(config["lower_bounds"],
                                 config["upper_bounds"],
                                 config["dimension_ranges"], act)
    centers, log_sigs = choose_centers(
        inputs.astype(np.float32), num_kernels=args.num_k,
        num_regions=config["num_regions"], seed=args.seed,
        input_scale=input_scale, lb=lb, ub=ub, activation_idx=act,
        x_dev=x_dev)
    t0 = wait_clock(device)
    if args.fit_mode == "per_region":
        fit = fit_per_region(inputs, outputs, centers, log_sigs, lb, ub,
                             config["delta"], tuple(act),
                             args.basis_function, input_scale=input_scale,
                             x_dev=x_dev, y_dev=y_dev)
    else:
        fit = fit_direct(x_dev[:n_rows], y_dev[:n_rows], centers, log_sigs,
                         lb, ub, config["delta"], tuple(act),
                         args.basis_function, input_scale=input_scale)
    print(f"direct fit in {wait_clock(device) - t0:.1f}s")
    # checkpoint BEFORE the probe, and probe in chunks: a full-table predict
    # materialises a (B, R, K) feature tensor beside the resident table
    install_fit(model, fit)
    ckpt_dir = os.path.abspath(os.path.join(args.out_dir, args.run_name))
    save_checkpoint(ckpt_dir, model, step=0)
    print(f"checkpoint at {ckpt_dir}")
    idx_all = torch.as_tensor(strided_rows(n_rows), device=device)
    l1_sum = torch.zeros((), dtype=torch.float64, device=device)
    with torch.no_grad():
        for i0 in range(0, idx_all.numel(), PROBE_CHUNK):
            idx = idx_all[i0:i0 + PROBE_CHUNK]
            pred = fit.predict(x_dev[idx], lb, ub, config["delta"],
                               tuple(act), args.basis_function)
            l1_sum += (pred - y_dev[idx]).abs().sum().double()
    l1 = float(l1_sum) / (idx_all.numel() * outputs.shape[1])
    print(f"control L1 {l1:.4f} (on {idx_all.numel():,} strided rows)")
    return l1


def main(argv=None) -> dict:
    args = parse_args(argv)
    device = resolve_device(args.device)
    inputs, outputs = load_table(args.npz_path)
    print(f"{inputs.shape[0]:,} feasible rows")
    if args.mirror_data:
        inputs, outputs = mirror_cartesian_table(inputs, outputs)

    splits = [getattr(args, f"num_{d}") for d in DIMS]
    lower_bounds, upper_bounds, dimension_ranges, delta = (
        region_spec_from_table(inputs, splits))
    num_regions = int(np.prod(splits))
    activation_idx = list(range(7))
    input_scale = tuple(float(v) for v in data_scale(inputs))
    # the JAX script's keys: rng, init_rng = split(PRNGKey(seed)); the net
    # starts from init_rng and the batches follow rng's last word
    batch_key, init_key = prng.split(prng.PRNGKey(args.seed))
    model = WCRBFNet(
        in_features=7, out_features=outputs.shape[1], num_kernels=args.num_k,
        basis_func=args.basis_function, num_regions=num_regions,
        lower_bounds=lower_bounds, upper_bounds=upper_bounds,
        dimension_ranges=dimension_ranges, activation_idx=activation_idx,
        delta=delta, input_scale=input_scale, head_mode=args.fit_mode,
        device=device, key=init_key)
    config = {
        "model_class": "WCRBFNet", "in_features": 7,
        "out_features": outputs.shape[1], "num_kernels": args.num_k,
        "basis_func": args.basis_function, "num_regions": num_regions,
        "lower_bounds": lower_bounds, "upper_bounds": upper_bounds,
        "dimension_ranges": dimension_ranges,
        "activation_idx": activation_idx, "delta": delta,
        "epochs": args.train_epochs, "lr": args.lr,
        "batch_size": args.batch_size, "seed": args.seed,
        "mu": args.mu, "cs": args.cs, "mirror": args.mirror_data,
        "input_scale": list(input_scale), "head_mode": args.fit_mode,
        "pipeline": "cartesian",
    }
    config_path = os.path.join(args.out_dir, f"{args.run_name}.json")
    save_config(config_path, config)
    ckpt_dir = os.path.abspath(os.path.join(args.out_dir, args.run_name))
    result = dict(model=model, config=config, config_path=config_path,
                  ckpt_dir=ckpt_dir)

    if args.direct_fit:
        result["fit_l1"] = _direct_fit(args, model, config, inputs, outputs,
                                       device)
        if args.finetune_epochs <= 0:
            return result
        args.train_epochs = args.finetune_epochs
        print(f"fine-tuning {args.finetune_epochs} epochs")
    if args.train_epochs <= 0:
        return result

    dyn_params = f1tenth_params(mu=args.mu, cs=args.cs,
                                device=device).to_vector()
    trainer = create_trainer(model, lr=args.lr,
                             max_grad_norm=args.max_grad_norm)
    logger = MetricLogger(
        path=os.path.join(args.out_dir, f"{args.run_name}.metrics.jsonl"),
        config=config)

    def log_fn(step, metrics):
        logger.log({"train_loss_batch": metrics.loss,
                    "pred_loss_batch": metrics.pred_loss,
                    "int_loss_batch": metrics.int_loss}, step=step)

    trainer, final_loss = train_epochs(
        trainer, make_train_step(cartesian_fullint_loss, dyn_params),
        inputs.astype(np.float32), outputs.astype(np.float32),
        min(args.batch_size, inputs.shape[0]), args.train_epochs,
        key_seed(batch_key), log_fn=log_fn,
        checkpoint_fn=lambda t, e: save_checkpoint(ckpt_dir, t.model,
                                                   step=e + 1))
    print(f"final mean loss {final_loss:.6f}; checkpoints at {ckpt_dir}")
    logger.close()
    result["final_loss"] = final_loss
    return result


if __name__ == "__main__":
    main()
