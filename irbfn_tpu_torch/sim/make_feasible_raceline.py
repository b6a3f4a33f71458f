"""Project a bundled raceline to width feasibility.

Port of ``scripts/make_feasible_raceline.py``. Some reference raceline CSVs
run closer to the occupancy wall than half a car width (Oschersleben pinches
to 0.143 m at s~135.7), undrivable under the sim's wall-contact collision
model. This produces a drivable line:

1. resample the raceline densely and measure EDT clearance along it
   (``sim/map.py:distance_at``, the field the sim collides against, read on
   the device: one batched call per clearance-and-gradient probe),
2. blend toward the centerline where the raceline lacks margin, then push
   sub-margin points outward along the EDT gradient until every point
   clears ``--margin``, re-smoothing around pushed points,
3. relax the curvature (gentle global smoothing alternated with re-pushes)
   until ``|kappa| <= --k_max``,
4. low-pass the written yaw/kappa columns and cap the speed profile at the
   original line's lateral-acceleration budget,
5. write a reference-format raceline CSV (``s; x; y; psi; kappa; vx``, the
   columns ``sim/map.py:raceline_from_csv`` parses).

The geometry passes are host numpy in f64, as in the JAX script; the
clearances are f32, as the map is.

Usage: ``python -m irbfn_tpu_torch.sim.make_feasible_raceline --map_dir
BUNDLE [--margin 0.35] [--out torch_runs/<name>_raceline_feasible.csv]
[--device cpu]``
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from irbfn_tpu_torch._device import resolve_device
from irbfn_tpu_torch.sim.map import distance_at, load_track_bundle

CSV_HEADER = "# s_m; x_m; y_m; psi_rad; kappa_radpm; vx_mps\n"


def edt_clearance_and_grad(omap, xy: np.ndarray, eps: float = 0.05):
    """Clearance and its central-difference world-frame gradient at
    ``(N, 2)`` points (the EDT is piecewise-bilinear; eps of a cell width
    reads the local slope robustly). The point and its four neighbours go
    through ``distance_at`` as one ``(5, N)`` batch on the map's device."""
    dist = omap.dist
    pts = torch.as_tensor(xy, dtype=dist.dtype, device=dist.device)
    x, y = pts[:, 0], pts[:, 1]
    d = distance_at(omap, torch.stack([x, x + eps, x - eps, x, x]),
                    torch.stack([y, y, y, y + eps, y - eps]))
    gx = (d[1] - d[2]) / (2 * eps)
    gy = (d[3] - d[4]) / (2 * eps)
    g = torch.stack([gx, gy], -1).cpu().numpy()
    n = np.linalg.norm(g, axis=-1, keepdims=True)
    return d[0].cpu().numpy(), g / np.maximum(n, 1e-9)


def smooth_periodic(xy: np.ndarray, alpha: float, iters: int) -> np.ndarray:
    """Periodic Laplacian smoothing: xy <- xy + alpha * (roll-avg - xy)."""
    for _ in range(iters):
        nbr = 0.5 * (np.roll(xy, 1, axis=0) + np.roll(xy, -1, axis=0))
        xy = xy + alpha * (nbr - xy)
    return xy


def resample_closed(arr: np.ndarray, n: int) -> np.ndarray:
    """Arc-length resample of closed per-point data to ``n`` uniform
    points; the first two columns are the polyline's xy."""
    xy = arr[:, :2]
    d = np.linalg.norm(np.roll(xy, -1, axis=0) - xy, axis=-1)
    s = np.concatenate([[0.0], np.cumsum(d)])
    si = np.linspace(0.0, s[-1], n, endpoint=False)
    cols = [np.interp(si, s, np.concatenate([arr[:, j], arr[:1, j]]))
            for j in range(arr.shape[1])]
    return np.stack(cols, -1)


def geometry(xy: np.ndarray):
    """(s, yaw, curvature, length) of a closed polyline via periodic
    gradients."""
    d = np.linalg.norm(np.roll(xy, -1, axis=0) - xy, axis=-1)
    s = np.concatenate([[0.0], np.cumsum(d)])[:-1]
    tang = 0.5 * (np.roll(xy, -1, axis=0) - np.roll(xy, 1, axis=0))
    yaw = np.arctan2(tang[:, 1], tang[:, 0])
    ds = 0.5 * (d + np.roll(d, 1))
    dyaw = np.angle(np.exp(1j * (np.roll(yaw, -1) - np.roll(yaw, 1))))
    k = dyaw / np.maximum(np.roll(ds, -1) + ds, 1e-9)
    return s, yaw, k, float(s[-1] + d[-1])


def periodic_filter(win: int):
    """A periodic moving average of ``win`` points."""
    kern = np.ones(win) / win

    def cfilt(a):
        pad = np.concatenate([a[-win:], a, a[:win]])
        return np.convolve(pad, kern, mode="same")[win:-win]

    return cfilt


def write_raceline_csv(path: str, comment: str, s, xy, yaw, k, vx) -> None:
    """The reference's raceline CSV: a header line, a comment line, rows of
    ``s; x; y; psi; kappa; vx`` at 6 decimals."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    rows = np.stack([s, xy[:, 0], xy[:, 1], yaw, k, vx], -1)
    with open(path, "w") as f:
        f.write(CSV_HEADER + f"# {comment}\n")
        np.savetxt(f, rows, delimiter="; ", fmt="%.6f")


def bundle_name(map_dir: str) -> str:
    return os.path.basename(os.path.normpath(map_dir))


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--map_dir", type=str, required=True)
    p.add_argument("--margin", type=float, default=0.35,
                   help="required EDT clearance (m): half car width 0.155 "
                        "+ the sim's default 0.15 disc + tracking slack")
    p.add_argument("--n_points", type=int, default=2000)
    p.add_argument("--push_iters", type=int, default=200)
    p.add_argument("--smooth_alpha", type=float, default=0.25)
    p.add_argument("--blend_centerline", type=int, default=1,
                   help="1: pre-blend toward the centerline at sub-margin "
                        "sections (corridor-shaped curvature) before the "
                        "push projection; 0: pure EDT push")
    p.add_argument("--blend_dilate", type=int, default=60,
                   help="rolling-max rounds widening the blend window so "
                        "the transition into/out of a pinch is gradual")
    p.add_argument("--relax_iters", type=int, default=2000,
                   help="smooth+re-push relaxation rounds for the curvature "
                        "cap")
    p.add_argument("--k_max", type=float, default=0.42,
                   help="target max |curvature| (inside the planner tables' "
                        "+-0.45 coverage)")
    p.add_argument("--a_lat", type=float, default=None,
                   help="lateral-accel budget (m/s^2) for the corner speed "
                        "cap; default = p98 of the original raceline's "
                        "|k|v^2; pass ~6 for a line drivable across the mu "
                        "sweep")
    p.add_argument("--geom_smooth_m", type=float, default=1.5,
                   help="moving-average window (meters) for the written "
                        "yaw/kappa columns")
    p.add_argument("--out", type=str, default=None,
                   help="the CSV to write (default: torch_runs/"
                        "<name>_raceline_feasible.csv)")
    p.add_argument("--device", type=str, default=None,
                   help="where the map and its clearance reads live "
                        "(default: the card)")
    return p.parse_args(argv)


def main(argv=None) -> str:
    args = parse_args(argv)
    out = args.out or os.path.join(
        "torch_runs", f"{bundle_name(args.map_dir)}_raceline_feasible.csv")
    track, omap = load_track_bundle(args.map_dir, prefer="raceline",
                                    device=resolve_device(args.device))
    rl = track.raceline
    xy0 = np.stack([rl.xs.cpu().numpy(), rl.ys.cpu().numpy()], -1)
    vx0 = rl.vxs.cpu().numpy()
    k0 = rl.ks.cpu().numpy()
    s0 = rl.ss.cpu().numpy()

    # the original line's lateral-acceleration budget: the speed cap law
    # below reproduces raceline pace wherever geometry is unchanged
    a_lat = (args.a_lat if args.a_lat is not None else
             float(np.percentile(np.abs(k0) * vx0**2, 98)))
    xy = resample_closed(xy0, args.n_points)
    d, _ = edt_clearance_and_grad(omap, xy)
    print(f"original: min clearance {d.min():.3f} m at s="
          f"{geometry(xy)[0][d.argmin()]:.1f}; a_lat budget {a_lat:.2f}")

    if args.blend_centerline:
        # pure outward pushing leaves a near-kink at each pinch (the margin
        # contour around a convex wall corner has radius ~= margin); the
        # centerline threads the same pinch with corridor-shaped curvature,
        # so blend toward it exactly where the raceline lacks margin
        name = bundle_name(args.map_dir)
        cpath = os.path.join(args.map_dir, f"{name}_centerline.csv")
        c = np.loadtxt(cpath, delimiter=",", skiprows=1)[:, :2]
        c = resample_closed(c, args.n_points)
        d2 = ((xy[:, None, :] - c[None, :, :]) ** 2).sum(-1)
        target = c[d2.argmin(1)]
        need = np.maximum(args.margin - d, 0.0) > 0.0
        w = need.astype(float)
        for _ in range(args.blend_dilate):
            w = np.maximum(w, 0.5 * (np.roll(w, 1) + np.roll(w, -1)))
        xy = xy + w[:, None] * (target - xy)
        xy = resample_closed(smooth_periodic(xy, 0.3, 4), args.n_points)
        d, _ = edt_clearance_and_grad(omap, xy)
        print(f"centerline blend over {int(need.sum())} deficient pts "
              f"(dilated {int((w > 0.01).sum())}): min clearance "
              f"{d.min():.3f} m, max|kappa| "
              f"{np.abs(geometry(xy)[2]).max():.3f}")

    for it in range(args.push_iters):
        d, g = edt_clearance_and_grad(omap, xy)
        need = np.maximum(args.margin - d, 0.0)
        if need.max() == 0.0 and it > 0:
            break
        xy = xy + (need[:, None] * g)
        # local smoothing only around pushed points (dilate the mask) so
        # untouched raceline geometry stays exactly raceline
        mask = need > 0
        for _ in range(8):
            mask = mask | np.roll(mask, 1) | np.roll(mask, -1)
        sm = smooth_periodic(xy, args.smooth_alpha, 2)
        xy = np.where(mask[:, None], sm, xy)
    # finishing pass: pure push (no smoothing) clears the residual few mm
    # the last smoothing iteration pulled back under margin
    for _ in range(20):
        d, g = edt_clearance_and_grad(omap, xy)
        need = np.maximum(args.margin - d, 0.0)
        if need.max() == 0.0:
            break
        xy = xy + need[:, None] * g
    d, _ = edt_clearance_and_grad(omap, xy)
    print(f"projected in {it + 1} iters: min clearance {d.min():.3f} m")
    assert d.min() >= args.margin - 1e-3, "projection failed to clear margin"

    # curvature relaxation: alternate gentle global smoothing with a re-push
    # to the margin, a relaxation whose fixed point is a smooth line ON the
    # margin boundary
    k_abs = np.abs(geometry(xy)[2]).max()
    rx = 0
    for rx in range(args.relax_iters):
        if k_abs <= args.k_max:
            break
        xy = smooth_periodic(xy, 0.1, 1)
        for _ in range(5):
            d, g = edt_clearance_and_grad(omap, xy)
            need = np.maximum(args.margin - d, 0.0)
            if need.max() == 0.0:
                break
            xy = xy + need[:, None] * g
        xy = resample_closed(xy, args.n_points)
        k_abs = np.abs(geometry(xy)[2]).max()
    d, _ = edt_clearance_and_grad(omap, xy)
    print(f"curvature relaxation: max|kappa| {k_abs:.3f} after {rx} iters, "
          f"min clearance {d.min():.3f} m")
    assert d.min() >= args.margin - 5e-3, "relaxation lost the margin"

    s, yaw, k, length = geometry(xy)
    # low-pass the consumed geometry columns: finite-difference yaw/kappa
    # of the pushed polyline are noisy, and the planner reads curvature and
    # heading error straight off them; the xy path itself is untouched
    win = max(3, int(round(args.geom_smooth_m / (length / len(s)))) | 1)
    cfilt = periodic_filter(win)
    yaw = np.angle(np.exp(1j * cfilt(np.unwrap(yaw))))
    k = cfilt(k)
    # speed: original profile interpolated by arc fraction, capped by the
    # new curvature at the original a_lat budget
    vx = np.interp(s / length * s0[-1], s0, vx0)
    vx = np.minimum(vx, np.sqrt(a_lat / np.maximum(np.abs(k), 1e-6)))
    print(f"geometry filter (window {win} pts ~ {args.geom_smooth_m} m): "
          f"k hf-rms {np.std(k - cfilt(k)):.4f}, max|k| {np.abs(k).max():.3f}")
    write_raceline_csv(out, f"width-feasible projection of {args.map_dir} "
                       f"raceline (margin {args.margin} m) — python -m "
                       "irbfn_tpu_torch.sim.make_feasible_raceline",
                       s, xy, yaw, k, vx)
    print(f"saved {out}: {len(s)} pts, length {length:.1f} m, "
          f"vx [{vx.min():.2f}, {vx.max():.2f}] m/s")
    return out


if __name__ == "__main__":
    main()
