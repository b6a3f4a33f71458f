"""Offline accuracy eval: forward the whole table through a trained net,
roll out predicted vs oracle control sequences, print the control L1 and
the first- and final-state ey / epsi / vx errors. Tables of millions of
rows stream through in chunks; only the sums leave the device.

Port of ``scripts/eval_offline.py``, with its flags and prints.

Usage: ``python -m irbfn_tpu_torch.train.eval_offline --config_f RUN.json
--ckpt RUN_DIR_OR_NPZ --npz_path TABLE [--mirror] [--device cpu]``
"""

from __future__ import annotations

import argparse

import torch

from irbfn_tpu_torch._device import resolve_device
from irbfn_tpu_torch.dynamics.frenet import integrate_frenet
from irbfn_tpu_torch.dynamics.params import f1tenth_params
from irbfn_tpu_torch.train.checkpoints import load_model
from irbfn_tpu_torch.train.train_frenet import load_table
from irbfn_tpu_torch.train.trainer import mirror_frenet_table


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--config_f", type=str, required=True)
    p.add_argument("--ckpt", type=str, required=True)
    p.add_argument("--npz_path", type=str, required=True)
    p.add_argument("--mirror", action="store_true")
    p.add_argument("--chunk", type=int, default=1 << 20)
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: the card)")
    return p.parse_args(argv)


@torch.no_grad()
def chunk_sums(model, dyn, x, y):
    """Per-chunk error SUMS: control |err| (row means summed), and the
    first/final-state |err| on ey, epsi, vx."""
    pred = model(x)
    if isinstance(pred, tuple):  # ClusterWCRBFNet returns (out, logits)
        pred = pred[0]
    init = x[:, [0, 0, 1, 2, 3, 5, 6, 7]]
    actual = integrate_frenet(torch.cat([init, y], dim=1), dyn)
    predicted = integrate_frenet(torch.cat([init, pred], dim=1), dyn)
    d = (predicted - actual).abs()
    picks = torch.stack([d[:, 0, 1].sum(), d[:, 0, 6].sum(),
                         d[:, 0, 3].sum(), d[:, -1, 1].sum(),
                         d[:, -1, 6].sum(), d[:, -1, 3].sum()])
    return (pred - y).abs().mean(dim=1).sum(), picks


def main(argv=None) -> dict:
    args = parse_args(argv)
    device = resolve_device(args.device)
    model, config = load_model(args.config_f, args.ckpt, device=device)
    model.eval()
    if config.get("model_class", "WCRBFNet") != "MLP":
        # every class but the MLP may materialise a (B, R, K) feature
        # tensor (the WCRBFNet's plain version on the CPU, the other
        # classes everywhere): 64k rows keep it at a few GB
        args.chunk = min(args.chunk, 1 << 16)
    inputs, outputs, valid = load_table(args.npz_path)
    inputs, outputs = inputs[valid], outputs[valid]
    if args.mirror:
        inputs, outputs = mirror_frenet_table(inputs, outputs)
    dyn = f1tenth_params(mu=config.get("mu", 1.0), cs=config.get("cs", 5.0),
                         device=device).to_vector()

    n = inputs.shape[0]
    ctrl_sum = torch.zeros((), dtype=torch.float64, device=device)
    pick_sum = torch.zeros((6,), dtype=torch.float64, device=device)
    for s in range(0, n, args.chunk):
        xs = torch.as_tensor(inputs[s:s + args.chunk],
                             dtype=torch.float32).to(device)
        ys = torch.as_tensor(outputs[s:s + args.chunk],
                             dtype=torch.float32).to(device)
        c, k = chunk_sums(model, dyn, xs, ys)
        ctrl_sum += c.double()
        pick_sum += k.double()

    ctrl = float(ctrl_sum) / n
    pick = pick_sum.cpu().numpy() / n
    print(f"control L1: {ctrl:.5f}")
    print(f"first state: ey MAE {pick[0]:.5f}  epsi MAE {pick[1]:.5f}  "
          f"vx MAE {pick[2]:.5f}")
    print(f"final state: ey MAE {pick[3]:.5f}  epsi MAE {pick[4]:.5f}  "
          f"vx MAE {pick[5]:.5f}")
    return dict(control_l1=ctrl, picks=pick)


if __name__ == "__main__":
    main()
