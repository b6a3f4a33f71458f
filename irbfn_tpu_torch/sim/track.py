"""Track / raceline with cartesian <-> Frenet conversion.

Port of ``irbfn_tpu/sim/track.py``. The raceline is a densely sampled
closed polyline, built on the host from control points with a periodic
Catmull-Rom spline (numpy, f64) and then cast to f32 tensors (``dtype``);
the conversions are batched tensor code that runs on the raceline's device.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from irbfn_tpu_torch._device import resolve_device


def wrap_angle(a):
    """Wrap to (-pi, pi]."""
    return a - 2.0 * math.pi * torch.floor((a + math.pi) / (2.0 * math.pi))


class Raceline(NamedTuple):
    ss: torch.Tensor  # arc length (N,)
    xs: torch.Tensor
    ys: torch.Tensor
    yaws: torch.Tensor
    ks: torch.Tensor  # curvature
    vxs: torch.Tensor  # speed profile
    length: torch.Tensor  # total track length (0-dim)

    @property
    def n_points(self) -> int:
        return self.xs.shape[0]

    @property
    def points(self) -> torch.Tensor:
        return torch.stack([self.xs, self.ys], dim=-1)


class Track(NamedTuple):
    raceline: Raceline

    def cartesian_to_frenet(self, x, y, theta):
        """(x, y, theta) -> (s, ey, epsi); batched over leading axes."""
        return cartesian_to_frenet(self.raceline, x, y, theta)

    def frenet_to_cartesian(self, s, ey, epsi):
        return frenet_to_cartesian(self.raceline, s, ey, epsi)

    def curvature_at(self, s):
        rl = self.raceline
        return interp_wrapped(rl.ss, rl.ks, s, rl.length)


def _catmull_rom_periodic(t_knots, values, ts):
    # a scalar loop, as the JAX package's, so both give the same bits
    m = len(values)
    res = np.zeros_like(ts)
    seg = np.clip(np.searchsorted(t_knots, ts, side="right") - 1, 0, m - 1)
    for i, (t, s) in enumerate(zip(ts, seg)):
        t0, t1 = t_knots[s], t_knots[s + 1]
        u = (t - t0) / max(t1 - t0, 1e-12)
        p0 = values[(s - 1) % m]
        p1 = values[s % m]
        p2 = values[(s + 1) % m]
        p3 = values[(s + 2) % m]
        res[i] = (
            0.5 * ((2 * p1) + (-p0 + p2) * u
                   + (2 * p0 - 5 * p1 + 4 * p2 - p3) * u**2
                   + (-p0 + 3 * p1 - 3 * p2 + p3) * u**3))
    return res


def _resample_closed(points: np.ndarray, n_samples: int) -> np.ndarray:
    """Periodic Catmull-Rom resampling of a closed control polygon, with a
    chordal parameterisation."""
    d = np.linalg.norm(np.roll(points, -1, axis=0) - points, axis=1)
    t_knots = np.concatenate([[0.0], np.cumsum(d)])
    ts = np.linspace(0.0, t_knots[-1], n_samples, endpoint=False)
    return np.stack([_catmull_rom_periodic(t_knots, points[:, dim], ts)
                     for dim in range(2)], axis=-1)


def from_control_points(points: np.ndarray, n_samples: int = 1024,
                        speed: float | np.ndarray = 4.0,
                        dtype=torch.float32, device=None) -> Track:
    """Build a closed Track from (M, 2) control points, on ``device``
    (None: the card)."""
    xy = _resample_closed(np.asarray(points, np.float64), n_samples)
    d = np.linalg.norm(np.roll(xy, -1, axis=0) - xy, axis=1)
    ss = np.concatenate([[0.0], np.cumsum(d)])[:-1]
    length = float(np.sum(d))
    tangents = np.roll(xy, -1, axis=0) - np.roll(xy, 1, axis=0)
    yaws = np.arctan2(tangents[:, 1], tangents[:, 0])
    # curvature via finite differences of unwrapped yaw over arc length
    dyaw = np.gradient(np.unwrap(yaws))
    ds = np.gradient(np.concatenate([ss, [length]])[:-1])
    ds[ds == 0] = 1e-9
    ks = dyaw / ds
    vxs = np.broadcast_to(np.asarray(speed, np.float64), (n_samples,))
    device = resolve_device(device)
    rl = Raceline(*[torch.tensor(np.asarray(a), dtype=dtype, device=device)
                    for a in (ss, xy[:, 0], xy[:, 1], yaws, ks, vxs, length)])
    return Track(rl)


def oval_track(length: float = 30.0, width: float = 15.0,
               n_samples: int = 1024, speed: float = 4.0,
               device=None) -> Track:
    """Synthetic rounded-rectangle (superellipse) test track."""
    t = np.linspace(0, 2 * np.pi, 64, endpoint=False)
    a, b, p = length / 2, width / 2, 4.0
    pts = np.stack([a * np.sign(np.cos(t)) * np.abs(np.cos(t)) ** (2 / p),
                    b * np.sign(np.sin(t)) * np.abs(np.sin(t)) ** (2 / p)],
                   axis=-1)
    return from_control_points(pts, n_samples, speed, device=device)


def centerline_from_arrays(xs, ys, speed=4.0, dtype=torch.float32,
                           device=None) -> Track:
    """Build a Track from raw centerline arrays (f1tenth-map style input)."""
    pts = np.stack([np.asarray(xs), np.asarray(ys)], axis=-1)
    return from_control_points(pts, n_samples=max(1024, 4 * len(pts)),
                               speed=speed, dtype=dtype, device=device)


def from_csv(path: str, x_col: int = 0, y_col: int = 1,
             speed_col: int | None = None, delimiter: str = ",",
             skip_header: int = 0, dtype=torch.float32,
             device=None) -> Track:
    """Load a closed track from a raceline/centerline CSV."""
    raw = np.genfromtxt(path, delimiter=delimiter, skip_header=skip_header)
    pts = raw[:, [x_col, y_col]]
    if np.allclose(pts[0], pts[-1]):  # drop a duplicated closing point
        pts = pts[:-1]
    speed = raw[:, speed_col].mean() if speed_col is not None else 4.0
    return from_control_points(pts, n_samples=max(1024, 4 * len(pts)),
                               speed=float(speed), dtype=dtype,
                               device=device)


# ---------------------------------------------------------------- conversions

def cartesian_to_frenet(rl: Raceline, x, y, theta):
    """Project pose(s) onto the raceline. Batched over leading axes."""
    pts = rl.points  # (N, 2)
    closed = torch.cat([pts, pts[:1]], dim=0)  # close the loop
    query = torch.stack(torch.broadcast_tensors(x, y), dim=-1)
    starts = closed[:-1]
    diffs = closed[1:] - starts
    l2 = torch.sum(diffs * diffs, dim=-1)
    rel = query[..., None, :] - starts
    t = torch.clamp(torch.sum(rel * diffs, dim=-1) / l2, 0.0, 1.0)
    proj = starts + t[..., None] * diffs
    d2 = torch.sum((query[..., None, :] - proj) ** 2, dim=-1)
    idx = torch.argmin(d2, dim=-1)
    t_best = torch.gather(t, -1, idx[..., None])[..., 0]
    seg_len = torch.sqrt(l2)[idx]
    s = rl.ss[idx] + t_best * seg_len
    # signed lateral offset: cross(tangent, offset)
    tangent = diffs[idx] / seg_len[..., None]
    proj_best = torch.gather(
        proj, -2, idx[..., None, None].expand(*idx.shape, 1, 2))[..., 0, :]
    off = query - proj_best
    ey = tangent[..., 0] * off[..., 1] - tangent[..., 1] * off[..., 0]
    yaw_ref = torch.atan2(tangent[..., 1], tangent[..., 0])
    epsi = wrap_angle(theta - yaw_ref)
    return s, ey, epsi


def frenet_to_cartesian(rl: Raceline, s, ey, epsi):
    s = torch.remainder(s, rl.length)
    n = rl.n_points
    idx = torch.clamp(_searchsorted_right(rl.ss, s) - 1, 0, n - 1)
    nxt = (idx + 1) % n
    seg_vec = torch.stack([rl.xs[nxt] - rl.xs[idx], rl.ys[nxt] - rl.ys[idx]],
                          dim=-1)
    seg_len = torch.sqrt(torch.sum(seg_vec * seg_vec, dim=-1))
    frac = torch.clamp((s - rl.ss[idx]) / torch.clamp(seg_len, min=1e-9),
                       0.0, 1.0)
    base = (torch.stack([rl.xs[idx], rl.ys[idx]], dim=-1)
            + frac[..., None] * seg_vec)
    tangent = seg_vec / torch.clamp(seg_len, min=1e-9)[..., None]
    normal = torch.stack([-tangent[..., 1], tangent[..., 0]], dim=-1)
    pos = base + ey[..., None] * normal
    yaw_ref = torch.atan2(tangent[..., 1], tangent[..., 0])
    return pos[..., 0], pos[..., 1], wrap_angle(yaw_ref + epsi)


def _searchsorted_right(ss, s):
    # compare in the wider dtype, as JAX's promoting searchsorted does
    return torch.searchsorted(ss.to(s.dtype), s.contiguous(), right=True)


def interp_wrapped(ss, vals, s, length):
    """Linear interpolation of a periodic profile ``vals(ss)`` at ``s``."""
    s = torch.remainder(s, length)
    n = ss.shape[0]
    idx = torch.clamp(_searchsorted_right(ss, s) - 1, 0, n - 1)
    nxt = (idx + 1) % n
    s1 = torch.where(nxt == 0, length.to(ss.dtype), ss[nxt])
    w = torch.clamp((s - ss[idx]) / torch.clamp(s1 - ss[idx], min=1e-9),
                    0.0, 1.0)
    return (1 - w) * vals[idx] + w * vals[nxt]


def horizon_goal_speed(rl: Raceline, s, vx, horizon_time=0.5):
    """Raceline goal speed at the END of the horizon's travel,
    ``s + vx * horizon_time`` (the table's vx_goal axis; sampling at the
    current s would lose corner-entry braking). ``horizon_time`` =
    horizon * control dt."""
    return interp_wrapped(rl.ss, rl.vxs, s + vx * horizon_time, rl.length)
