"""Trajectory endpoint-error evaluation of a clothoid LUT or of a net
trained on it.

Port of ``scripts/eval_lut_accuracy.py``, with the same flags and prints
plus ``--device``: integrate the LUT entries (or a trained net's
predictions) and report the endpoint error against the goal poses, its
planar-miss tail, and the classical O(h^2) interpolation bound (for a C^2
target interpolated on a grid of fill distance h, with the constant from
the table's second differences).

The net's predictions go through ``WCRBFNet.forward`` under ``no_grad`` in
``--chunk`` rows, in the port's one lattice chunk loop
(``parallel/datagen.py:solve_lattice_sharded``: pinned staging, the copies
back overlapped with the next chunk, the ``lattice.*`` spans and counters;
under a process group the ranks split each chunk): on the card that is the
fused RBF kernel, which never materialises the (rows, regions, kernels)
feature tensor. The endpoints come from ``integrate_endpoint_gl`` in f64, a
chunk at a time, on the same device.

Usage: ``python -m irbfn_tpu_torch.train.eval_lut_accuracy --lut_path LUT
[--config_f RUN.json --ckpt RUN_DIR_OR_NPZ] [--chunk 262144] [--device cpu]``
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from irbfn_tpu_torch._device import resolve_device
from irbfn_tpu_torch.dynamics.spiral import integrate_endpoint_gl
from irbfn_tpu_torch.parallel.datagen import solve_lattice_sharded
from irbfn_tpu_torch.solvers.clothoid import wrap_angle


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--lut_path", type=str, required=True)
    p.add_argument("--config_f", type=str, default=None)
    p.add_argument("--ckpt", type=str, default=None)
    p.add_argument("--chunk", type=int, default=1 << 18,
                   help="rows per device pass")
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: the card)")
    return p.parse_args(argv)


def load_lut(path: str) -> dict:
    """The LUT npz with its goal rows: ``lut``, ``xlut``, ``ylut``,
    ``tlut``, ``goals`` (N, 3) and ``params`` (N, 5) ('ij' order)."""
    with np.load(path) as data:
        out = {k: data[k] for k in ("lut", "xlut", "ylut", "tlut")}
    X, Y, T = np.meshgrid(out["xlut"], out["ylut"], out["tlut"],
                          indexing="ij")
    out["goals"] = np.stack([X, Y, T], axis=-1).reshape(-1, 3)
    out["params"] = out["lut"].reshape(-1, 5)
    return out


@torch.no_grad()
def net_params(model, goals: np.ndarray, chunk: int = 1 << 18) -> np.ndarray:
    """The net's spiral params for every goal, (N, O) float32: ``chunk``
    rows per forward on the model's device (the fused kernel on the card),
    through the lattice chunk loop, on a world of one unless a process
    group is up."""
    dev = next(model.parameters()).device
    rows = np.asarray(goals, dtype=np.float32)
    return solve_lattice_sharded(model, rows, batch_per_device=chunk,
                                 device=dev)


@torch.no_grad()
def endpoint_errors(goals: np.ndarray, params: np.ndarray,
                    chunk: int = 1 << 18, device=None) -> dict:
    """|x|, |y|, |wrapped theta| and planar endpoint misses (numpy (N,))
    of the spirals ``params`` against ``goals``, integrated in f64."""
    device = resolve_device(device)
    n = goals.shape[0]
    errs = {k: np.empty(n, np.float64) for k in ("x", "y", "theta", "xy")}
    for i0 in range(0, n, chunk):
        g = torch.as_tensor(goals[i0:i0 + chunk], dtype=torch.float64,
                            device=device)
        p = torch.as_tensor(params[i0:i0 + chunk], dtype=torch.float64,
                            device=device)
        end = integrate_endpoint_gl(p)
        d = end[:, :2] - g[:, :2]
        for k, v in (("x", d[:, 0].abs()), ("y", d[:, 1].abs()),
                     ("theta", wrap_angle(end[:, 2] - g[:, 2]).abs()),
                     ("xy", torch.hypot(d[:, 0], d[:, 1]))):
            errs[k][i0:i0 + chunk] = v.cpu().numpy()
    return errs


def interpolation_bound(lut: np.ndarray, axes) -> tuple:
    """(0.25 max|d2 k0| h^2, h): the O(h^2) bound on k0 from the table's
    second differences and the fill distance ``h``."""
    hs = [np.diff(g).mean() for g in axes if len(g) > 1]
    h = float(np.linalg.norm(hs))
    curv_est = 0.0
    k0 = lut[..., 0]
    for ax in range(3):
        if lut.shape[ax] > 2:
            d2 = np.diff(k0, n=2, axis=ax) / (hs[ax] ** 2 if ax < len(hs)
                                              else 1)
            curv_est = max(curv_est, float(np.abs(d2).max()))
    return 0.25 * curv_est * h ** 2, h


def report(label: str, errs: dict, lut: np.ndarray, axes) -> dict:
    """Print the reference's lines; returns the numbers printed."""
    n = errs["x"].shape[0]
    ex, ey, et, exy = errs["x"], errs["y"], errs["theta"], errs["xy"]
    print(f"{label} endpoint error over {n:,} goals:")
    print(f"  x:     mean {ex.mean():.2e}  max {ex.max():.2e}")
    print(f"  y:     mean {ey.mean():.2e}  max {ey.max():.2e}")
    print(f"  theta: mean {et.mean():.2e}  max {et.max():.2e}")
    # tail of the planar miss (long-chord goals amplify param error ~s^2/2)
    stats = dict(
        x_mean=float(ex.mean()), x_max=float(ex.max()),
        y_mean=float(ey.mean()), y_max=float(ey.max()),
        theta_mean=float(et.mean()), theta_max=float(et.max()),
        p99=float(np.percentile(exy, 99)),
        p999=float(np.percentile(exy, 99.9)), miss_max=float(exy.max()),
        over_1m=float(100 * (exy > 1).mean()),
        over_5m=float(100 * (exy > 5).mean()))
    print(f"  planar miss: p99 {stats['p99']:.3f}  "
          f"p99.9 {stats['p999']:.3f}  max {stats['miss_max']:.3f}  "
          f">1m {stats['over_1m']:.3f}%  >5m {stats['over_5m']:.4f}%")
    bound, h = interpolation_bound(lut, axes)
    print(f"theoretical O(h^2) interpolation bound on k0: {bound:.2e} "
          f"(fill distance h={h:.3f}, N={n:,})")
    stats.update(bound=bound, h=h)
    return stats


def main(argv=None) -> dict:
    args = parse_args(argv)
    device = resolve_device(args.device)
    data = load_lut(args.lut_path)
    goals, params = data["goals"], data["params"]
    if args.config_f:
        from irbfn_tpu_torch.train.checkpoints import load_model

        model, _ = load_model(args.config_f, args.ckpt, device=device)
        params = net_params(model, goals, args.chunk)
        label = "net prediction"
    else:
        label = "LUT entry"
    errs = endpoint_errors(goals, params, args.chunk, device)
    return report(label, errs, data["lut"],
                  (data["xlut"], data["ylut"], data["tlut"]))


if __name__ == "__main__":
    main()
