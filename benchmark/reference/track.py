"""Plain reference of the oval track and its Frenet projection.

The raceline is built as the reference planners build it: a superellipse's
64 control points, resampled by a periodic Catmull-Rom spline with chordal
knots, arc length, yaw from central differences and curvature from the
unwrapped yaw. Projections run in the tensors' dtype on their device.

``project`` returns the nearest segment's projection and, where a second
segment lies within ``tie`` of the same squared distance, that segment's
projection too: outside a convex vertex both neighbours project onto the
vertex, and which of the two a float32 argmin picks is decided by rounding.
The two give the same s and nearly the same ey, but headings that differ by
the vertex's turn, so a check accepts either.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch


class Line(NamedTuple):
    ss: torch.Tensor
    xs: torch.Tensor
    ys: torch.Tensor
    ks: torch.Tensor
    vxs: torch.Tensor
    length: float


def _catmull_rom_periodic(t_knots, values, ts):
    m = len(values)
    seg = np.clip(np.searchsorted(t_knots, ts, side="right") - 1, 0, m - 1)
    t0, t1 = t_knots[seg], t_knots[seg + 1]
    u = (ts - t0) / np.maximum(t1 - t0, 1e-12)
    p0 = values[(seg - 1) % m]
    p1 = values[seg % m]
    p2 = values[(seg + 1) % m]
    p3 = values[(seg + 2) % m]
    return 0.5 * ((2 * p1) + (-p0 + p2) * u
                  + (2 * p0 - 5 * p1 + 4 * p2 - p3) * u**2
                  + (-p0 + 3 * p1 - 3 * p2 + p3) * u**3)


def oval_points(length: float, width: float) -> np.ndarray:
    t = np.linspace(0, 2 * np.pi, 64, endpoint=False)
    a, b, p = length / 2, width / 2, 4.0
    return np.stack([a * np.sign(np.cos(t)) * np.abs(np.cos(t)) ** (2 / p),
                     b * np.sign(np.sin(t)) * np.abs(np.sin(t)) ** (2 / p)],
                    axis=-1)


def oval_line(length: float, width: float, n_samples: int, speed: float,
              dtype=torch.float64, device="cpu") -> Line:
    pts = oval_points(length, width)
    d = np.linalg.norm(np.roll(pts, -1, axis=0) - pts, axis=1)
    t_knots = np.concatenate([[0.0], np.cumsum(d)])
    ts = np.linspace(0.0, t_knots[-1], n_samples, endpoint=False)
    xy = np.stack([_catmull_rom_periodic(t_knots, pts[:, k], ts)
                   for k in range(2)], axis=-1)
    seg = np.linalg.norm(np.roll(xy, -1, axis=0) - xy, axis=1)
    ss = np.concatenate([[0.0], np.cumsum(seg)])[:-1]
    length_total = float(np.sum(seg))
    tangents = np.roll(xy, -1, axis=0) - np.roll(xy, 1, axis=0)
    yaws = np.arctan2(tangents[:, 1], tangents[:, 0])
    dyaw = np.gradient(np.unwrap(yaws))
    ds = np.gradient(np.concatenate([ss, [length_total]])[:-1])
    ds[ds == 0] = 1e-9
    ks = dyaw / ds
    vxs = np.full(n_samples, float(speed))

    def t(a):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    return Line(t(ss), t(xy[:, 0]), t(xy[:, 1]), t(ks), t(vxs), length_total)


def wrap_angle(a):
    return a - 2.0 * math.pi * torch.floor((a + math.pi) / (2.0 * math.pi))


def interp_wrapped(line: Line, vals, s):
    """Linear interpolation of a periodic profile at arc length s."""
    s = torch.remainder(s, line.length)
    n = line.ss.shape[0]
    idx = torch.clamp(torch.searchsorted(line.ss, s.contiguous(),
                                         right=True) - 1, 0, n - 1)
    nxt = (idx + 1) % n
    s1 = torch.where(nxt == 0, torch.full_like(s, line.length),
                     line.ss[nxt])
    w = torch.clamp((s - line.ss[idx]) / torch.clamp(s1 - line.ss[idx],
                                                     min=1e-9), 0.0, 1.0)
    return (1 - w) * vals[idx] + w * vals[nxt]


def frenet_to_cartesian(line: Line, s, ey):
    """Point and heading at arc length s, offset ey along the normal."""
    s = torch.remainder(s, line.length)
    n = line.ss.shape[0]
    idx = torch.clamp(torch.searchsorted(line.ss, s.contiguous(),
                                         right=True) - 1, 0, n - 1)
    nxt = (idx + 1) % n
    vx = line.xs[nxt] - line.xs[idx]
    vy = line.ys[nxt] - line.ys[idx]
    seg_len = torch.clamp(torch.sqrt(vx * vx + vy * vy), min=1e-9)
    frac = torch.clamp((s - line.ss[idx]) / seg_len, 0.0, 1.0)
    tx, ty = vx / seg_len, vy / seg_len
    x = line.xs[idx] + frac * vx - ey * ty
    y = line.ys[idx] + frac * vy + ey * tx
    return x, y, wrap_angle(torch.atan2(ty, tx))


class Projection(NamedTuple):
    s: torch.Tensor
    ey: torch.Tensor
    epsi: torch.Tensor


def _project_on(line: Line, x, y, theta, idx, t_all):
    n = line.ss.shape[0]
    nxt = (idx + 1) % n
    dx = line.xs[nxt] - line.xs[idx]
    dy = line.ys[nxt] - line.ys[idx]
    seg_len = torch.sqrt(dx * dx + dy * dy)
    t = torch.gather(t_all, -1, idx[..., None])[..., 0]
    s = line.ss[idx] + t * seg_len
    px = line.xs[idx] + t * dx
    py = line.ys[idx] + t * dy
    tx, ty = dx / seg_len, dy / seg_len
    ey = tx * (y - py) - ty * (x - px)
    epsi = wrap_angle(theta - torch.atan2(ty, tx))
    return Projection(s, ey, epsi)


def project(line: Line, x, y, theta, tie: float = 1e-5):
    """(nearest, second, tied): the projection on the nearest segment, the
    one on the next nearest, and where the two distances lie within ``tie``
    (m) of each other: a float32 position is off by ~1e-6 m."""
    x0, y0 = line.xs, line.ys
    x1, y1 = torch.roll(line.xs, -1), torch.roll(line.ys, -1)
    dx, dy = x1 - x0, y1 - y0
    l2 = dx * dx + dy * dy
    rx = x[..., None] - x0
    ry = y[..., None] - y0
    t = torch.clamp((rx * dx + ry * dy) / l2, 0.0, 1.0)
    ex = rx - t * dx
    ey_ = ry - t * dy
    d2 = ex * ex + ey_ * ey_
    best = torch.topk(d2, 2, dim=-1, largest=False)
    d_first, d_second = best.values[..., 0], best.values[..., 1]
    tied = (torch.sqrt(d_second) - torch.sqrt(d_first)) <= tie
    first = _project_on(line, x, y, theta, best.indices[..., 0], t)
    second = _project_on(line, x, y, theta, best.indices[..., 1], t)
    return first, second, tied
