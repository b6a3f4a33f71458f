"""Plain reference of the goal-reaching kinematic MPC and its ADMM solve.

Per problem: state [x, y, v, yaw] over T steps, controls [accel, steer],
the dynamics linearised at (v = v_car, yaw = 0, steer = 0), a quadratic
goal-tracking cost with control and control-difference penalties, and boxes
on the controls, the steering rate and the speed. The states are condensed
out (float64, numpy), so each problem is a 2T-dim box QP in the controls;
its constraint rows are scaled to unit norm, rho = max(1, |v_car| / 2), and
a fixed number of over-relaxed ADMM sweeps (alpha 1.6, sigma 1e-6) solve
it from zero. The first step's speed is ``v_car + a_0 dt`` and its steer
``delta_0``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from benchmark.reference.precision import dtype_of, matmul


class Problem(NamedTuple):
    horizon: int = 8
    dt: float = 0.05
    wheelbase: float = 0.33
    r_accel: float = 0.01
    r_steer: float = 5.0
    rd_accel: float = 0.05
    rd_steer: float = 50.0
    q_state: tuple = (5.0, 5.0, 10.0, 1.0)
    qf_state: tuple = (15.0, 15.0, 10.0, 1.0)
    max_steer: float = 0.4189
    max_dsteer_deg: float = 180.0
    max_speed: float = 10.0
    min_speed: float = -2.0
    max_accel: float = 10.0


def family(v: float, pb: Problem) -> dict:
    """The condensed QP of one linearization speed, float64 numpy: ``A``
    (m, n) unit rows, ``lo``/``hi`` (m,), ``kinv`` (n, n), ``rho``,
    ``Su`` (4T, n), ``x_free`` (4T,), ``qw`` (4T,)."""
    T, nx, nu = pb.horizon, 4, 2
    n = T * nu
    dt = pb.dt
    Ad = np.array([[1, 0, dt, 0], [0, 1, 0, dt * v], [0, 0, 1, 0],
                   [0, 0, 0, 1]], np.float64)
    Bd = np.zeros((nx, nu))
    Bd[2, 0] = dt
    Bd[3, 1] = dt * v / pb.wheelbase
    powers = [np.eye(nx)]
    for _ in range(T):
        powers.append(Ad @ powers[-1])
    Su = np.zeros((T * nx, n))
    for k in range(1, T + 1):
        for j in range(k):
            Su[(k - 1) * nx:k * nx, j * nu:(j + 1) * nu] = (
                powers[k - 1 - j] @ Bd)
    x0 = np.array([0.0, 0.0, v, 0.0])
    x_free = np.concatenate([powers[k] @ x0 for k in range(1, T + 1)])
    qw = np.concatenate([np.tile(pb.q_state, T - 1), pb.qf_state])
    D = np.zeros(((T - 1) * nu, n))
    steer_rows = np.zeros((T - 1, n))
    for k in range(T - 1):
        for c in range(nu):
            D[k * nu + c, (k + 1) * nu + c] = 1.0
            D[k * nu + c, k * nu + c] = -1.0
        steer_rows[k, (k + 1) * nu + 1] = 1.0
        steer_rows[k, k * nu + 1] = -1.0
    r_diag = np.tile([pb.r_accel, pb.r_steer], T)
    rd_diag = np.tile([pb.rd_accel, pb.rd_steer], T - 1)
    P = Su.T @ (qw[:, None] * Su) + np.diag(r_diag) + D.T @ (
        rd_diag[:, None] * D)
    vel_sel = np.zeros((T, T * nx))
    for k in range(T):
        vel_sel[k, k * nx + 2] = 1.0
    A = np.concatenate([np.eye(n), steer_rows, vel_sel @ Su])
    d_bound = np.deg2rad(pb.max_dsteer_deg) * dt
    lo = np.concatenate([np.tile([-pb.max_accel, -pb.max_steer], T),
                         np.full(T - 1, -d_bound),
                         np.full(T, pb.min_speed) - v])
    hi = np.concatenate([np.tile([pb.max_accel, pb.max_steer], T),
                         np.full(T - 1, d_bound),
                         np.full(T, pb.max_speed) - v])
    norm = np.sqrt((A * A).sum(-1))
    A, lo, hi = A / norm[:, None], lo / norm, hi / norm
    rho = max(1.0, abs(v) * 0.5)
    return dict(A=A, lo=lo, hi=hi, rho=rho, Su=Su, x_free=x_free, qw=qw,
                kinv=np.linalg.inv(P + 1e-6 * np.eye(n) + rho * A.T @ A))


def solve(v: float, goals: np.ndarray, pb: Problem, sweeps: int,
          precision: str = "f64", device="cpu", tol: float = 2e-3) -> dict:
    """ADMM over goal rows ``(G, 4)`` = (x_g, y_g, v_g, yaw_g) of one
    family. Returns numpy ``speed``, ``steer``, ``r_prim``, ``r_dual``,
    ``converged`` (G,)."""
    fam = family(float(v), pb)
    dtype = dtype_of(precision)

    def t(a):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    A, lo, hi, kinv = t(fam["A"]), t(fam["lo"]), t(fam["hi"]), t(fam["kinv"])
    rho = fam["rho"]
    g = t(goals)
    g_rep = g.repeat(1, pb.horizon)
    q = matmul(t(fam["qw"]) * (t(fam["x_free"]) - g_rep), t(fam["Su"]),
               precision)
    sigma, alpha = 1e-6, 1.6
    At, kinvt = A.T.contiguous(), kinv.T.contiguous()
    x = torch.zeros_like(q)
    z = torch.clamp(q.new_zeros((q.shape[0], A.shape[0])), lo, hi)
    u = torch.zeros_like(z)
    for _ in range(sweeps):
        rhs = sigma * x - q + matmul(rho * (z - u), A, precision)
        x = matmul(rhs, kinvt, precision)
        ax = alpha * matmul(x, At, precision) + (1.0 - alpha) * z
        z_new = torch.clamp(ax + u, lo, hi)
        u = u + ax - z_new
        z = z_new
    ax = matmul(x, At, precision)
    z_next = torch.clamp(ax + u, lo, hi)
    r_prim = (ax - z_next).abs().amax(-1)
    r_dual = rho * matmul(z_next - z, A, precision).abs().amax(-1)
    out = dict(speed=float(v) + x[:, 0] * pb.dt, steer=x[:, 1],
               r_prim=r_prim, r_dual=r_dual,
               converged=(r_prim < tol) & (r_dual < tol))
    return {k: v.cpu().numpy() for k, v in out.items()}


def lattice_axes(grid: dict) -> dict:
    """The lattice's axes from ``{name: [lo, hi, step]}``: ``linspace(lo,
    hi, round((hi - lo) / step) + 1)``, as the table generator lays them."""
    return {k: np.linspace(lo, hi, int(round((hi - lo) / st)) + 1)
            for k, (lo, hi, st) in grid.items()}


def goal_block(axes: dict) -> np.ndarray:
    """A family's goals (G, 4), rows in the table's order ('ij' over x, y,
    yaw, v) and columns in the solver's (x, y, v, yaw), float32."""
    mesh = np.meshgrid(axes["x_goal"], axes["y_goal"], axes["t_goal"],
                       axes["v_goal"], indexing="ij")
    raw = np.stack([m.reshape(-1) for m in mesh], axis=-1).astype(np.float32)
    return np.ascontiguousarray(raw[:, [0, 1, 3, 2]])
