"""Minimum-curvature width-feasible raceline.

Port of ``scripts/min_curv_raceline.py``. The EDT push projection
(``sim/make_feasible_raceline.py``) guarantees clearance but converges to
margin-contour geometry, |kappa| ~ 0.6+ at Oschersleben's pinches, outside
the planner tables' +-0.45 coverage. This solves the line the raceline
literature solves (the TUM minimum-curvature QP): the path is centerline +
alpha(s) * normal(s); the summed squared periodic second differences
(curvature energy, quadratic in alpha) are minimised with alpha boxed to
the centerline CSV's corridor less the clearance margin. The box QP is
solved exactly by an active-set Newton in f64 numpy: the biharmonic
Hessian's condition number grows as (n/pi)^4 (~1e10 at n = 800), which
stalls a first-order ADMM (60k iterations left r_prim ~1e-2), while only
the few pinch points bind. An outer loop re-measures the true clearance
with the sim's EDT (``sim/map.py:distance_at``, on the device) and tightens
the violated boxes, because constant-width columns overstate the corridor
at corners.

Usage: ``python -m irbfn_tpu_torch.sim.min_curv_raceline --map_dir BUNDLE
[--margin 0.35] [--out torch_runs/<name>_raceline_mincurv.csv]
[--device cpu]``
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from irbfn_tpu_torch._device import resolve_device
from irbfn_tpu_torch.sim.make_feasible_raceline import (
    bundle_name, edt_clearance_and_grad, geometry, periodic_filter,
    resample_closed, write_raceline_csv)
from irbfn_tpu_torch.sim.map import load_track_bundle


def curvature_qp(c: np.ndarray, nrm: np.ndarray, h: float):
    """``(P, q)`` of the curvature energy of ``c + alpha * nrm`` in
    ``alpha``: ``|D2 (c + alpha nrm)|^2``, D2 the periodic second
    difference over spacing ``h``."""
    n = len(c)
    D2 = (np.roll(np.eye(n), -1, 1) - 2 * np.eye(n)
          + np.roll(np.eye(n), 1, 1)) / h**2
    Bx, By = D2 * nrm[:, 0][None, :], D2 * nrm[:, 1][None, :]
    bx, by = D2 @ c[:, 0], D2 @ c[:, 1]
    P = 2.0 * (Bx.T @ Bx + By.T @ By)
    q = 2.0 * (Bx.T @ bx + By.T @ by)
    return P, q


def solve_box_qp_active_set(P, q, lo, hi, rounds: int = 60):
    """Exact box QP ``min 1/2 x'Px + q'x, lo <= x <= hi`` by active-set
    Newton: fix the active set, solve the reduced equality system exactly
    (a dense f64 solve), release actives whose multiplier has the wrong
    sign and activate violated bounds. Returns ``(x, converged)``."""
    n_ = P.shape[0]
    active_lo = np.zeros(n_, bool)
    active_hi = np.zeros(n_, bool)
    for _ in range(rounds):
        free = ~(active_lo | active_hi)
        x = np.where(active_lo, lo, np.where(active_hi, hi, 0.0))
        rhs = -(q + P[:, ~free] @ x[~free])
        x[free] = np.linalg.solve(P[np.ix_(free, free)], rhs[free])
        # KKT: release actives whose multiplier sign is wrong
        g = P @ x + q
        rel_lo = active_lo & (g < -1e-12)
        rel_hi = active_hi & (g > 1e-12)
        viol_lo = free & (x < lo - 1e-12)
        viol_hi = free & (x > hi + 1e-12)
        if not (rel_lo.any() or rel_hi.any()
                or viol_lo.any() or viol_hi.any()):
            return np.clip(x, lo, hi), True
        active_lo = (active_lo & ~rel_lo) | viol_lo
        active_hi = (active_hi & ~rel_hi) | viol_hi
    return np.clip(x, lo, hi), False


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--map_dir", type=str, required=True)
    p.add_argument("--margin", type=float, default=0.35)
    p.add_argument("--n_points", type=int, default=800)
    p.add_argument("--a_lat", type=float, default=6.0,
                   help="lateral-accel budget for the speed cap (m/s^2); "
                        "~0.7g so the mu sweep's low-grip rows can hold it")
    p.add_argument("--admm_iters", type=int, default=60000,
                   help="kept for the JAX script's command line; the box "
                        "QP is solved by active set, not ADMM")
    p.add_argument("--outer", type=int, default=4,
                   help="EDT-verify + box-tighten rounds")
    p.add_argument("--geom_smooth_m", type=float, default=1.0)
    p.add_argument("--out", type=str, default=None,
                   help="the CSV to write (default: torch_runs/"
                        "<name>_raceline_mincurv.csv)")
    p.add_argument("--device", type=str, default=None,
                   help="where the map and its clearance reads live "
                        "(default: the card)")
    return p.parse_args(argv)


def main(argv=None) -> str:
    args = parse_args(argv)
    name = bundle_name(args.map_dir)
    out = args.out or os.path.join("torch_runs",
                                   f"{name}_raceline_mincurv.csv")
    cl = np.loadtxt(os.path.join(args.map_dir, f"{name}_centerline.csv"),
                    delimiter=",", skiprows=1)  # x, y, w_right, w_left
    track, omap = load_track_bundle(args.map_dir, prefer="raceline",
                                    device=resolve_device(args.device))
    rl = track.raceline
    s0 = rl.ss.cpu().numpy()
    vx0 = rl.vxs.cpu().numpy()

    n = args.n_points
    cl = resample_closed(cl, n)
    c, wr, wl = cl[:, :2], cl[:, 2], cl[:, 3]
    s, yaw, _, length = geometry(c)
    h = length / n
    tang = np.stack([np.cos(yaw), np.sin(yaw)], -1)
    nrm = np.stack([-tang[:, 1], tang[:, 0]], -1)  # left of travel
    lo = -(wr - args.margin)
    hi = wl - args.margin
    P, q = curvature_qp(c, nrm, h)

    for outer in range(args.outer):
        alpha, conv = solve_box_qp_active_set(P, q, lo, hi)
        xy = c + alpha[:, None] * nrm
        d = edt_clearance_and_grad(omap, xy)[0]
        k_now = np.abs(geometry(xy)[2]).max()
        print(f"outer {outer}: active-set converged {conv}, "
              f"min EDT clearance {d.min():.3f} m, max|kappa| {k_now:.3f}")
        bad = d < args.margin - 1e-3
        if not bad.any():
            break
        # the constant-width columns overstate the corridor here: pull the
        # violated boxes toward the centerline by the measured deficit
        deficit = (args.margin - d)[bad]
        sign = np.sign(alpha[bad] + 1e-12)
        hi[bad] = np.where(sign > 0, np.maximum(alpha[bad] - deficit, 0.0),
                           hi[bad])
        lo[bad] = np.where(sign < 0, np.minimum(alpha[bad] + deficit, 0.0),
                           lo[bad])

    s, yaw, k, length = geometry(xy)
    win = max(3, int(round(args.geom_smooth_m / (length / n))) | 1)
    cfilt = periodic_filter(win)
    yaw = np.angle(np.exp(1j * cfilt(np.unwrap(yaw))))
    k = cfilt(k)
    vx = np.interp(s / length * s0[-1], s0, vx0)
    vx = np.minimum(vx, np.sqrt(args.a_lat / np.maximum(np.abs(k), 1e-6)))
    write_raceline_csv(out, f"min-curvature width-feasible line for "
                       f"{args.map_dir} (margin {args.margin} m) — "
                       "python -m irbfn_tpu_torch.sim.min_curv_raceline",
                       s, xy, yaw, k, vx)
    print(f"saved {out}: {n} pts, length {length:.1f} m, max|kappa| "
          f"{np.abs(k).max():.3f}, vx [{vx.min():.2f}, {vx.max():.2f}] m/s, "
          f"min clearance {d.min():.3f} m")
    return out


if __name__ == "__main__":
    main()
