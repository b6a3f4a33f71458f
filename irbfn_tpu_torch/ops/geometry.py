"""Raceline geometry primitives, batched tensor code.

Port of ``irbfn_tpu/ops/geometry.py``: the nearest point on a polyline and
the first intersection of a polyline with a circle, both branchless over
every segment at once (the reference's early-exit host loops become one
masked argmin), plus the 2-D rotation matrix and the [0, 2*pi) wrap.
"""

from __future__ import annotations

import math

import torch


def nearest_point(point: torch.Tensor, trajectory: torch.Tensor):
    """Nearest point on a piecewise-linear trajectory.

    ``point`` (..., 2), ``trajectory`` (N, 2) with distinct points. Returns
    (projection (..., 2), distance (...,), segment fraction t (...,),
    segment index (...,))."""
    point = torch.as_tensor(point, dtype=trajectory.dtype,
                            device=trajectory.device)
    starts = trajectory[:-1]  # (S, 2)
    diffs = trajectory[1:] - starts  # (S, 2)
    l2 = torch.sum(diffs * diffs, dim=-1)  # (S,)
    rel = point[..., None, :] - starts  # (..., S, 2)
    t = torch.clamp(torch.sum(rel * diffs, dim=-1) / l2, 0.0, 1.0)
    proj = starts + t[..., None] * diffs  # (..., S, 2)
    d2 = torch.sum((point[..., None, :] - proj) ** 2, dim=-1)
    idx = torch.argmin(d2, dim=-1)
    proj_best = torch.gather(
        proj, -2, idx[..., None, None].expand(*idx.shape, 1, 2))[..., 0, :]
    t_best = torch.gather(t, -1, idx[..., None])[..., 0]
    d_best = torch.sqrt(torch.gather(d2, -1, idx[..., None])[..., 0])
    return proj_best, d_best, t_best, idx


def intersect_point(point: torch.Tensor, radius, trajectory: torch.Tensor,
                    t: float = 0.0, wrap: bool = False):
    """First intersection of the trajectory with a circle of ``radius``
    around ``point`` (2,), searching forward from fractional index ``t``.

    The quadratic is solved for every segment at once, hits behind the start
    are masked, and the first valid segment wins. Returns (intersection
    point (2,), segment index, segment fraction); the index is -1 and the
    point and fraction NaN when nothing intersects. ``wrap`` visits every
    segment once, forward from the start and round the end."""
    dev, dt = trajectory.device, trajectory.dtype
    point = torch.as_tensor(point, dtype=dt, device=dev)
    n_seg = trajectory.shape[0] - 1
    t = torch.as_tensor(t, dtype=dt, device=dev)
    start_i = torch.floor(t).to(torch.int64)
    start_t = torch.remainder(t, 1.0)
    ar = torch.arange(n_seg, device=dev)
    seg_order = (start_i + ar) % n_seg if wrap else ar

    starts = trajectory[seg_order]
    ends = trajectory[(seg_order + 1) % trajectory.shape[0]] + 1e-6
    V = ends - starts
    a = torch.sum(V * V, dim=-1)
    to_start = starts - point
    b = 2.0 * torch.sum(V * to_start, dim=-1)
    c = torch.sum(to_start * to_start, dim=-1) - radius * radius
    disc = b * b - 4.0 * a * c
    valid = disc >= 0.0
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    t1 = (-b - sq) / (2.0 * a)
    t2 = (-b + sq) / (2.0 * a)

    lo = torch.where(seg_order == start_i, start_t, torch.zeros_like(start_t))
    t1_ok = valid & (t1 >= lo) & (t1 <= 1.0)
    t2_ok = valid & (t2 >= lo) & (t2 <= 1.0)
    inf = torch.full_like(t1, math.inf)
    t_seg = torch.where(t1_ok, t1, torch.where(t2_ok, t2, inf))
    hit = torch.isfinite(t_seg)
    if not wrap:  # forward search only: segments before the start miss
        hit = hit & (seg_order >= start_i)

    big = torch.iinfo(torch.int32).max
    first_pos = torch.argmin(torch.where(hit, ar, torch.full_like(ar, big)))
    any_hit = torch.any(hit)
    seg_idx = torch.where(any_hit, seg_order[first_pos],
                          torch.full_like(seg_order[first_pos], -1))
    t_hit = t_seg[first_pos]
    p_hit = starts[first_pos] + t_hit * V[first_pos]
    nan = torch.full_like(p_hit, math.nan)
    return (torch.where(any_hit, p_hit, nan), seg_idx,
            torch.where(any_hit, t_hit, nan[0]))


def rotation_matrix(theta):
    """(..., 2, 2) rotation by ``theta``."""
    theta = torch.as_tensor(theta)
    c, s = torch.cos(theta), torch.sin(theta)
    return torch.stack([torch.stack([c, -s], -1), torch.stack([s, c], -1)],
                       -2)


def zero_to_2pi(angle):
    """Wrap to [0, 2*pi)."""
    return torch.remainder(torch.as_tensor(angle), 2.0 * math.pi)
