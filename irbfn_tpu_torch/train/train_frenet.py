"""Flagship Frenet trainer: loads a solver table, filters infeasible rows,
optionally mirrors it, builds region bounds from the grid, and trains a
WCRBF-family model with the prediction + integration losses, or fits it in
closed form with ``--direct_fit`` (then optionally fine-tunes it,
``--finetune_epochs``).

Port of ``scripts/train_frenet.py``, with its flags (``utils/args.py``) and
prints. Writes ``<out_dir>/<run_name>.json`` (the config) beside the
checkpoint directory ``<out_dir>/<run_name>/`` (``step_<n>.npz``): the pair
the planners load through ``train.load_model``.

Usage: ``python -m irbfn_tpu_torch.train.train_frenet --npz_path TABLE
[--mirror_data] [--direct_fit --fit_mode per_region] [--deeper | --mlp |
--use_cluster] [--device cpu]``
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from irbfn_tpu_torch._device import resolve_device, wait_clock
from irbfn_tpu_torch.dynamics.params import f1tenth_params
from irbfn_tpu_torch.models import build_region_bounds, from_config
from irbfn_tpu_torch.models.fit import (choose_centers, data_scale,
                                        device_table, fit_direct,
                                        fit_per_region, install_fit,
                                        tube_weights, widths_from_centers)
from irbfn_tpu_torch.parallel.datagen import controls_block
from irbfn_tpu_torch.train.checkpoints import save_checkpoint, save_config
from irbfn_tpu_torch.train.train_goal_mpc import PROBE_CHUNK, strided_rows
from irbfn_tpu_torch.train.trainer import (cluster_fullint_loss,
                                           create_trainer,
                                           frenet_fullint_loss,
                                           frenet_oneint_loss,
                                           key_seed, make_train_step,
                                           mirror_frenet_table,
                                           region_spec_from_table,
                                           train_epochs)
from irbfn_tpu_torch.utils import prng
from irbfn_tpu_torch.utils.args import (add_device_args, add_train_args,
                                        add_vehicle_args)
from irbfn_tpu_torch.utils.metrics import MetricLogger

DIMS = ["ey", "delta", "vx_car", "vy_car", "vx_goal", "wz", "epsi", "curv"]


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    add_train_args(p)
    add_vehicle_args(p)
    add_device_args(p)
    return p.parse_args(argv)


def load_table(npz_path: str):
    """(inputs, outputs (N, 2T) in block layout, the feasible-row mask)."""
    with np.load(npz_path) as data:
        inputs, outputs = data["inputs"], controls_block(data["outputs"])
    valid = ~np.any(outputs == -999.0, axis=1)
    return inputs, outputs, valid


def _direct_fit(args, model, config, inputs, outputs, centers, device):
    """The closed-form fit: centers and widths chosen, the head weights
    solved, all installed into ``model``, checkpointed as step 0, then the
    strided L1 probe."""
    activation_idx = config["activation_idx"]
    input_scale = tuple(config["input_scale"])
    num_regions = config["num_regions"]
    basis = args.basis_function
    ckpt_dir = os.path.abspath(os.path.join(args.out_dir, args.run_name))

    # the table goes to the device once: the tube weighting and the
    # per-region gram passes gather their rows there
    t0 = wait_clock(device)
    x_dev, y_dev, n_rows = device_table(inputs, outputs, device=device)
    mb = (x_dev.numel() + y_dev.numel()) * 4 / 2**20
    print(f"table resident on device in {wait_clock(device) - t0:.1f}s "
          f"({mb:.0f} MB)")
    lb, ub = build_region_bounds(config["lower_bounds"],
                                 config["upper_bounds"],
                                 config["dimension_ranges"], activation_idx)
    sample_weight = None
    if args.tube_npz:
        tube = np.load(args.tube_npz)["states"]
        t0 = wait_clock(device)
        sample_weight = tube_weights(inputs, tube, input_scale=input_scale,
                                     bandwidth=args.tube_bandwidth,
                                     floor=args.tube_floor, x_dev=x_dev)
        frac = float((sample_weight > 2 * args.tube_floor).mean())
        print(f"tube weights from {tube.shape[0]} visited states in "
              f"{wait_clock(device) - t0:.1f}s; {100 * frac:.1f}% of rows "
              "substantially weighted")
    if centers is not None:
        # constraint-cluster warm starts (--use_centers): every region
        # shares the top-k activation-pattern mode centers; widths from the
        # nearest-neighbor recipe choose_centers uses
        c_np = np.broadcast_to(
            np.asarray(centers, np.float32),
            (num_regions,) + np.asarray(centers).shape).copy()
        centers = torch.as_tensor(c_np).to(device)
        log_sigs = torch.as_tensor(widths_from_centers(
            c_np, input_scale=input_scale).astype(np.float32)).to(device)
    else:
        centers, log_sigs = choose_centers(
            inputs.astype(np.float32), num_kernels=args.num_k,
            num_regions=num_regions, seed=args.seed, input_scale=input_scale,
            lb=lb, ub=ub, activation_idx=activation_idx,
            probs=sample_weight, x_dev=x_dev)
    t0 = wait_clock(device)
    if args.fit_mode == "per_region":
        fit = fit_per_region(inputs, outputs, centers, log_sigs, lb, ub,
                             config["delta"], tuple(activation_idx), basis,
                             input_scale=input_scale,
                             sample_weight=sample_weight, x_dev=x_dev,
                             y_dev=y_dev)
    else:
        fit = fit_direct(x_dev[:n_rows], y_dev[:n_rows], centers, log_sigs,
                         lb, ub, config["delta"], tuple(activation_idx),
                         basis, input_scale=input_scale,
                         sample_weight=sample_weight)
    print(f"direct fit in {wait_clock(device) - t0:.1f}s")
    # install into the model so that planners load it, and CHECKPOINT BEFORE
    # the L1 probe: a long fit of a GB-scale table must not be lost to an
    # out-of-memory error in the diagnostics ((B, R, K) per-region feature
    # intermediates on top of the resident table), which is also why the
    # probe goes in chunks
    install_fit(model, fit)
    save_checkpoint(ckpt_dir, model, step=0)
    print(f"checkpoint at {ckpt_dir}")
    # strided TRUE rows: x_dev is zero-PADDED to a chunk multiple, so plain
    # slices would average padding rows into the L1
    idx_all = torch.as_tensor(strided_rows(n_rows), device=device)
    l1_sum = torch.zeros((), dtype=torch.float64, device=device)
    with torch.no_grad():
        for i0 in range(0, idx_all.numel(), PROBE_CHUNK):
            idx = idx_all[i0:i0 + PROBE_CHUNK]
            pred = fit.predict(x_dev[idx], lb, ub, config["delta"],
                               tuple(activation_idx), basis)
            l1_sum += (pred - y_dev[idx]).abs().sum().double()
    l1 = float(l1_sum) / (idx_all.numel() * outputs.shape[1])
    print(f"control L1 {l1:.4f} (on {idx_all.numel():,} strided rows)")
    return l1


def main(argv=None) -> dict:
    args = parse_args(argv)
    device = resolve_device(args.device)
    inputs, outputs, valid = load_table(args.npz_path)
    inputs, outputs = inputs[valid], outputs[valid]
    print(f"{inputs.shape[0]:,} feasible rows")

    if args.mirror_data:
        if args.use_cluster:
            # cluster ids are per-TABLE-row (they align with the unmirrored
            # table); the reflected copy's active-constraint pattern is a
            # permutation of the original's, not the same id, so mirror
            # augmentation would mislabel half the CE targets
            raise SystemExit("--use_cluster is incompatible with "
                             "--mirror_data (cluster ids align with the "
                             "unmirrored table)")
        inputs, outputs = mirror_frenet_table(inputs, outputs)
    if args.only_onestep:
        T = outputs.shape[1] // 2
        outputs = outputs[:, [0, T]]

    splits = [getattr(args, f"num_{d}") for d in DIMS]
    lower_bounds, upper_bounds, dimension_ranges, delta = (
        region_spec_from_table(inputs, splits))
    num_regions = int(np.prod(splits))
    activation_idx = list(range(8))

    centers = None
    if args.use_centers:
        cdata = np.load(args.npz_path[:-4] + args.centers_name +
                        args.npz_path[-4:])
        centers = cdata["centers"]
        # the cluster bank IS the kernel budget (one kernel per top-k
        # activation pattern)
        args.num_k = int(centers.shape[0])

    # anisotropic RBF metric: each input dim normalised by its data std, so
    # that e.g. curvature (+-0.45) and velocity (1-8) contribute comparably
    # to kernel distances
    input_scale = tuple(float(v) for v in data_scale(inputs))

    model_class = "WCRBFNet"
    if args.deeper:
        model_class = "DeeperWCRBFNet"
    elif args.mlp:
        model_class = "MLP"
    elif args.use_cluster:
        model_class = "ClusterWCRBFNet"
        num_regions = args.num_clusters + 1

    config = {
        "model_class": model_class, "in_features": 8,
        "out_features": outputs.shape[1], "num_kernels": args.num_k,
        "basis_func": args.basis_function, "num_regions": num_regions,
        "lower_bounds": lower_bounds, "upper_bounds": upper_bounds,
        "dimension_ranges": dimension_ranges,
        "activation_idx": activation_idx, "delta": delta,
        "epochs": args.train_epochs, "lr": args.lr,
        "batch_size": args.batch_size, "seed": args.seed,
        "mu": args.mu, "cs": args.cs,
        "fixed_centers": args.fixed_centers, "fixed_width": args.fixed_width,
        "input_scale": list(input_scale),
        "head_mode": args.fit_mode if model_class == "WCRBFNet" else "shared",
    }
    # the JAX script's keys: rng, init_rng = split(PRNGKey(seed)); the net
    # starts from init_rng and the batches follow rng's last word
    batch_key, init_key = prng.split(prng.PRNGKey(args.seed))
    model = from_config(config, device=device, key=init_key,
                        centers=centers if model_class == "WCRBFNet"
                        else None)
    save_config(os.path.join(args.out_dir, f"{args.run_name}.json"), config)
    ckpt_dir = os.path.abspath(os.path.join(args.out_dir, args.run_name))
    bs = min(args.batch_size, inputs.shape[0])
    result = dict(model=model, config=config, ckpt_dir=ckpt_dir)

    if args.direct_fit:
        result["fit_l1"] = _direct_fit(args, model, config, inputs, outputs,
                                       centers, device)
        if args.finetune_epochs <= 0:
            return result
        # fine-tune from the closed-form warm start with the integration
        # loss: the pure control-matching fit minimises pointwise error but
        # not the dynamic consistency of the control SEQUENCE the planner
        # executes
        args.train_epochs = args.finetune_epochs
        print(f"fine-tuning {args.finetune_epochs} epochs "
              "with the integration loss")

    dyn_params = f1tenth_params(mu=args.mu, cs=args.cs,
                                device=device).to_vector()

    cluster_extra = None
    if args.use_cluster:
        cdata = np.load(args.npz_path[:-4] +
                        f"_{args.num_clusters}_cluster_ids" +
                        args.npz_path[-4:])
        # integer labels, not one-hots (trainer.py:cluster_fullint_loss)
        cluster_extra = cdata["cluster_int_ids"][valid].astype(np.int64)
        loss_fn = cluster_fullint_loss
    elif args.only_onestep:
        loss_fn = frenet_oneint_loss
    else:
        loss_fn = frenet_fullint_loss

    trainer = create_trainer(model, lr=args.lr,
                             max_grad_norm=args.max_grad_norm)
    logger = MetricLogger(
        path=os.path.join(args.out_dir, f"{args.run_name}.metrics.jsonl"),
        config=config)

    def log_fn(step, metrics):
        logger.log({"train_loss_batch": metrics.loss,
                    "pred_loss_batch": metrics.pred_loss,
                    "int_loss_batch": metrics.int_loss,
                    "cluster_loss_batch": metrics.cluster_loss}, step=step)

    def ckpt_fn(trainer, epoch):
        # epoch e saves as step e+1: step 0 is the --direct_fit warm start
        save_checkpoint(ckpt_dir, trainer.model, step=epoch + 1)

    trainer, final_loss = train_epochs(
        trainer, make_train_step(loss_fn, dyn_params),
        inputs.astype(np.float32), outputs.astype(np.float32), bs,
        args.train_epochs, key_seed(batch_key), extra=cluster_extra,
        log_fn=log_fn,
        checkpoint_fn=ckpt_fn)
    print(f"final mean loss {final_loss:.6f}; checkpoints at {ckpt_dir}")
    logger.close()
    result["final_loss"] = final_loss
    return result


if __name__ == "__main__":
    main()
