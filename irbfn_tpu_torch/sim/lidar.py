"""Planar lidar scan against a track corridor.

Port of ``irbfn_tpu/sim/lidar.py``: every (pose, beam, sample) point is
evaluated at once. Each sample's distance to the raceline polyline (the
minimum over its segments) says whether it lies outside the drivable
corridor, and a beam's range is its first sample outside, or the maximum
range. The (poses, beams, samples, segments) intermediate is large (1,000
poses x 64 x 64 x 128 segments is 2 GB per f32 tensor), so the poses go
through in chunks; each pose's scan is computed the same way whatever the
chunk.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from irbfn_tpu_torch.sim.map import linspace
from irbfn_tpu_torch.sim.track import Track

# elements of the (poses, beams, samples, segments) tensors per chunk: 2^25
# f32 elements are 128 MB, and ~8 such tensors are alive at once
CHUNK_ELEMENTS = 1 << 25


class LidarSpec(NamedTuple):
    n_beams: int = 64
    fov: float = 4.7  # radians (the f1tenth 270-degree scanner)
    max_range: float = 10.0
    n_samples: int = 64  # samples per ray


def _segment_distance(pts, starts, diffs, l2):
    """Distance of points (..., 2) to the closed polyline's segments: the
    minimum over segments."""
    rel = pts[..., None, :] - starts  # (..., N, 2)
    t = torch.clamp(torch.sum(rel * diffs, dim=-1) / l2, 0.0, 1.0)
    proj = starts + t[..., None] * diffs
    d2 = torch.sum((pts[..., None, :] - proj) ** 2, dim=-1)
    return torch.sqrt(torch.amin(d2, dim=-1))


def _polyline(track_points):
    diffs = torch.roll(track_points, -1, dims=0) - track_points
    return track_points, diffs, torch.sum(diffs * diffs, dim=-1)


def scan(track_points: torch.Tensor, half_width: float, x, y, theta,
         spec: LidarSpec = LidarSpec()) -> torch.Tensor:
    """Simulate a scan, batched over the leading axes of (x, y, theta).

    Args:
        track_points: (N, 2) raceline polyline; its dtype and device are
            the scan's.
        half_width: drivable corridor half width around the raceline.
    Returns:
        ranges (..., n_beams)
    """
    dt, dev = track_points.dtype, track_points.device
    x, y, theta = (torch.as_tensor(a, dtype=dt, device=dev)
                   for a in (x, y, theta))
    x, y, theta = torch.broadcast_tensors(x, y, theta)
    batch = x.shape
    angles = linspace(-spec.fov / 2, spec.fov / 2, spec.n_beams, dt, dev)
    ts = linspace(0.0, 1.0, spec.n_samples, dt, dev) * spec.max_range
    poly = _polyline(track_points)
    x, y, theta = x.reshape(-1), y.reshape(-1), theta.reshape(-1)
    per_pose = spec.n_beams * spec.n_samples * track_points.shape[0]
    chunk = max(1, CHUNK_ELEMENTS // per_pose)
    out = []
    for i in range(0, x.shape[0], chunk):
        beam_theta = theta[i:i + chunk, None] + angles  # (P, B)
        px = x[i:i + chunk, None, None] + torch.cos(beam_theta)[..., None] * ts
        py = y[i:i + chunk, None, None] + torch.sin(beam_theta)[..., None] * ts
        d = _segment_distance(torch.stack([px, py], dim=-1), *poly)
        outside = d > half_width  # (P, B, S)
        # the first sample outside (argmax of a bool picks the first True)
        first = torch.argmax(outside.to(torch.uint8), dim=-1)
        out.append(torch.where(outside.any(-1), ts[first],
                               torch.full_like(ts[first], spec.max_range)))
    ranges = (torch.cat(out) if out else
              x.new_zeros((0, spec.n_beams)))
    return ranges.reshape(batch + (spec.n_beams,))


def make_scanner(track: Track, half_width: float = 2.0,
                 spec: LidarSpec = LidarSpec(), decimate: int = 4):
    """Bind a track into a ``(x, y, theta) -> ranges`` scanner.

    ``decimate`` subsamples the raceline polyline to bound the distance
    tensor; corridor walls are smooth, so 4x decimation changes ranges well
    below the scanner's sample spacing."""
    pts = track.raceline.points[::decimate]

    def scanner(x, y, theta):
        return scan(pts, half_width, x, y, theta, spec)

    return scanner


def min_clearance(track_points: torch.Tensor, half_width: float, x, y):
    """Distance from pose(s) to the corridor wall (negative = outside)."""
    dt, dev = track_points.dtype, track_points.device
    pts = torch.stack([torch.as_tensor(x, dtype=dt, device=dev),
                       torch.as_tensor(y, dtype=dt, device=dev)], dim=-1)
    return half_width - _segment_distance(pts, *_polyline(track_points))


__all__ = ["LidarSpec", "make_scanner", "min_clearance", "scan"]
