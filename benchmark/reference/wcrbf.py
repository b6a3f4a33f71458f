"""Plain reference of the region-blended RBF net (WCRBFNet) and of the
Frenet planner's query around it.

The net, as published: a smooth box gate per region over the split input
dims, ``prod_d s(delta_d (x_d - lb_rd)) s(delta_d (ub_rd - x_d))`` with
``s(t) = (tanh(t) + 1) / 2``; for per-region heads the gates normalised to
sum 1 (plus 1e-9); the basis of the scaled distance ``||s * (x - c_rk)|| /
exp(log_sig_rk)``; and a linear head over ``[gamma_r phi_rk ; gamma_r]``.
It reads the config JSON and the weights' npz as they are committed, and
materialises the (B, R, K) basis tensor, in blocks of rows.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from benchmark.reference.precision import dtype_of, matmul

BASES = {
    "gaussian": lambda a: torch.exp(-(a * a)),
    "inverse_quadratic": lambda a: 1.0 / (1.0 + a * a),
}


def load_net(config_json: str, weights_npz: str, precision: str = "f64",
             device="cpu") -> dict:
    """The net's constants and weights as tensors in ``precision``."""
    with open(config_json) as f:
        conf = json.load(f)
    if conf.get("model_class", "WCRBFNet") != "WCRBFNet":
        raise ValueError("the reference serves WCRBFNet only")
    with np.load(weights_npz) as z:
        w = {k: np.asarray(z[k], np.float64) for k in z.files}
    R, K = int(conf["num_regions"]), int(conf["num_kernels"])
    act = [int(d) for d in conf["activation_idx"]]
    lb = np.zeros((R, len(act)))
    ub = np.zeros((R, len(act)))
    for r, seg in enumerate(conf["dimension_ranges"]):
        for j in range(len(act)):
            lb[r, j] = conf["lower_bounds"][j][int(seg[j])]
            ub[r, j] = conf["upper_bounds"][j][int(seg[j])]
    F = int(conf["in_features"])
    scale = np.asarray(conf.get("input_scale") or np.ones(F), np.float64)
    bounds = np.full((F, 2), (-np.inf, np.inf))
    for j, d in enumerate(act):
        bounds[d] = (min(conf["lower_bounds"][j]),
                     max(conf["upper_bounds"][j]))
    dtype = dtype_of(precision)

    def t(a):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    return dict(
        precision=precision, act=act, per_region=conf["head_mode"] == "per_region",
        basis=conf["basis_func"], R=R, K=K,
        lb=t(lb), ub=t(ub), delta=t(conf["delta"]), scale=t(scale),
        centers=t(w["params/core/centers"]),
        inv_sig=t(np.exp(-w["params/core/log_sigs"])),
        head=t(w["params/head/kernel"]), bias=t(w["params/head/bias"]),
        bounds=t(bounds))


def forward(net: dict, x: torch.Tensor, block: int = 4096) -> torch.Tensor:
    """``(B, F) -> (B, O)`` in the net's precision, ``block`` rows at a
    time."""
    return torch.cat([_forward(net, x[i:i + block])
                      for i in range(0, x.shape[0], block)])


def _forward(net: dict, x: torch.Tensor) -> torch.Tensor:
    prec = net["precision"]
    x = x.to(net["scale"].dtype)
    xa = x[:, net["act"]]
    lo = (torch.tanh(net["delta"] * (xa[:, None, :] - net["lb"])) + 1) * 0.5
    hi = (torch.tanh(net["delta"] * (net["ub"] - xa[:, None, :])) + 1) * 0.5
    gamma = torch.prod(lo * hi, dim=-1)  # (B, R)
    if net["per_region"]:
        gamma = gamma / (gamma.sum(-1, keepdim=True) + 1e-9)
    xs = x * net["scale"]
    cs = net["centers"] * net["scale"]  # (R, K, F)
    d2 = torch.zeros((x.shape[0],) + cs.shape[:2], dtype=x.dtype,
                     device=x.device)
    for f in range(x.shape[1]):
        diff = xs[:, f, None, None] - cs[None, :, :, f]
        d2 = d2 + diff * diff
    dist = torch.sqrt(torch.clamp(d2, min=1e-30)) * net["inv_sig"]
    gphi = gamma[:, :, None] * BASES[net["basis"]](dist)  # (B, R, K)
    R, K = net["R"], net["K"]
    W = net["head"]
    if net["per_region"]:
        feats = torch.cat([gphi.reshape(x.shape[0], R * K), gamma], dim=-1)
        return matmul(feats, W, prec) + net["bias"]
    return matmul(gphi.sum(1), W, prec) + net["bias"]


MIRROR_EY = -0.05


def frenet_action(net: dict, ey, delta, vx, vy, vx_goal, wz, epsi, curv,
                  mirror_flip=None) -> torch.Tensor:
    """The planner's first controls ``(B, 2)`` = [accel, steer_vel]: the
    exact reflection where ey < -0.05 (ey, delta, vy, wz, epsi and curv
    flip, and the steer rates flip back), the clamp into the trained box,
    the net. ``mirror_flip`` (bool (B,)) inverts the mirror decision of those
    lanes: the other side of a tie at the threshold."""
    need = ey < MIRROR_EY
    if mirror_flip is not None:
        need = need ^ mirror_flip
    sign = torch.where(need, -1.0, 1.0).to(ey.dtype)
    q = torch.stack([sign * ey, sign * delta, vx, sign * vy, vx_goal,
                     sign * wz, sign * epsi, sign * curv], dim=-1)
    b = net["bounds"].to(q.dtype)
    q = torch.minimum(torch.maximum(q, b[:, 0]), b[:, 1])
    u = forward(net, q)
    T = u.shape[-1] // 2
    return torch.stack([u[:, 0], sign.to(u.dtype) * u[:, T]], dim=-1)
