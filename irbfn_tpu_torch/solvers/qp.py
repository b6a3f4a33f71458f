"""Batched ADMM quadratic programming and the condensed linear MPC.

Port of ``irbfn_tpu/solvers/qp.py``. The OSQP algorithm (ADMM splitting on
``Ax = z`` with z boxed) solves a batch of

    min 0.5 x^T P x + q^T x   s.t.  lo <= A x <= hi

with one factorisation per problem (the KKT matrix does not change between
sweeps for a fixed rho). The condensed linear MPC on top of it shares one P
across the whole batch with A = I, so it takes a second solver that inverts
that one KKT matrix once and sweeps every problem with one (B, n) x (n, n)
product.

The two solvers stop differently, as in the JAX package:

- ``solve_qp_batch`` runs each problem until it converges or reaches
  ``iters``; a converged problem's state freezes and ``iterations`` is its
  own sweep count;
- ``_solve_box_qp_shared`` sweeps every problem until all have converged
  or ``iters`` is reached (one host read per sweep); ``iterations`` counts
  the sweeps after which a problem was not yet converged.

Plain PyTorch: no Pallas kernel computes any of this in the JAX package.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from irbfn_tpu_torch._device import resolve_device
from irbfn_tpu_torch.ops.admm import _clip


class QPSolution(NamedTuple):
    x: torch.Tensor  # (..., n)
    primal_residual: torch.Tensor  # (...,)
    dual_residual: torch.Tensor  # (...,)
    iterations: torch.Tensor  # (...,) int32
    converged: torch.Tensor  # (...,) bool


# Over-relaxation: roughly halves the iterations to a given residual on the
# goal-MPC family; the standard OSQP range.
_ALPHA = 1.6


def _mv(M, v):
    """Batched matrix-vector product (..., m, n) x (..., n) -> (..., m)."""
    return (M @ v[..., None])[..., 0]


def solve_qp_batch(P, q, A, lo, hi, rho: float | None = None,
                   sigma: float = 1e-6, iters: int = 2000,
                   tol: float = 1e-8) -> QPSolution:
    """Solve a batch of box-constrained QPs, each to its own convergence.

    Args:
        P: (..., n, n) PSD cost; q: (..., n); A: (..., m, n); lo/hi:
        (..., m); all on one device, in one dtype. ``rho`` None: each
        problem's own clip(mean(diag P), 1e-3, 1e3).
    Returns:
        a QPSolution of batch shape ``q.shape[:-1]``; the residuals are L2
        norms.
    """
    batch = q.shape[:-1]
    n, m = q.shape[-1], A.shape[-2]
    P, q = P.reshape(-1, n, n), q.reshape(-1, n)
    A, lo, hi = A.reshape(-1, m, n), lo.reshape(-1, m), hi.reshape(-1, m)
    B = q.shape[0]
    eye = torch.eye(n, dtype=P.dtype, device=P.device)
    if rho is None:
        rho_t = torch.clamp(torch.diagonal(P, dim1=-2, dim2=-1).mean(-1),
                            1e-3, 1e3)
    else:
        rho_t = torch.full((B,), float(rho), dtype=P.dtype, device=P.device)
    At = A.transpose(-1, -2)
    kkt = P + sigma * eye + rho_t[:, None, None] * (At @ A)
    chol = torch.linalg.cholesky(kkt)

    x = torch.zeros_like(q)
    z = _clip(_mv(A, x), lo, hi)
    u = torch.zeros_like(z)
    it = torch.zeros(B, dtype=torch.int32, device=q.device)
    done = torch.zeros(B, dtype=torch.bool, device=q.device)
    for _ in range(iters):
        active = ~done & (it < iters)
        if not bool(active.any()):
            break
        rhs = sigma * x - q + _mv(At, rho_t[:, None] * (z - u))
        x_new = torch.cholesky_solve(rhs[..., None], chol)[..., 0]
        ax_true = _mv(A, x_new)
        ax = _ALPHA * ax_true + (1.0 - _ALPHA) * z
        z_new = _clip(ax + u, lo, hi)
        u_new = u + ax - z_new
        r_prim = torch.linalg.vector_norm(ax_true - z_new, dim=-1)
        r_dual = rho_t * torch.linalg.vector_norm(_mv(At, z_new - z), dim=-1)
        done_new = done | ((r_prim < tol) & (r_dual < tol))
        # a problem whose loop has ended keeps its state (the vmapped
        # while_loop's select)
        a = active[:, None]
        x = torch.where(a, x_new, x)
        z = torch.where(a, z_new, z)
        u = torch.where(a, u_new, u)
        it = it + active.to(torch.int32)
        done = torch.where(active, done_new, done)
    ax = _mv(A, x)
    r_prim = torch.linalg.vector_norm(ax - _clip(ax, lo, hi), dim=-1)
    r_dual = torch.linalg.vector_norm(
        _mv(P, x) + q + _mv(At, rho_t[:, None] * u), dim=-1)
    out = (x, r_prim, r_dual, it, done)
    return QPSolution(*(t.reshape(batch + t.shape[1:]) for t in out))


def _solve_box_qp_shared(P, q, lo, hi, rho: float = 1.0,
                         sigma: float = 1e-6, iters: int = 1000,
                         tol: float = 1e-4) -> QPSolution:
    """ADMM for a batch sharing one P with identity constraints (lo <= x <=
    hi): only q varies across the batch.

    One KKT inverse (P + (sigma + rho) I, in P's dtype) serves every
    problem; each sweep is one (B, n) x (n, n) product. The state runs in
    the promoted dtype of q and P. With A = I the constraint rows are unit
    rows, so a scale-matched rho (mean(diag P), as
    ``solve_linear_mpc_batch`` passes) balances the x-update against the
    projection. The residuals are max-abs norms.
    """
    n = P.shape[-1]
    kinv = torch.linalg.inv(P + (sigma + rho) * torch.eye(
        n, dtype=P.dtype, device=P.device))
    dtype = torch.promote_types(q.dtype, P.dtype)
    q, kinv, P = q.to(dtype), kinv.to(dtype), P.to(dtype)
    lo, hi = lo.to(dtype), hi.to(dtype)
    x = torch.zeros_like(q)
    z = _clip(x, lo, hi)
    u = torch.zeros_like(q)
    it = torch.zeros(q.shape[:-1], dtype=torch.int32, device=q.device)
    done = torch.zeros(q.shape[:-1], dtype=torch.bool, device=q.device)
    for _ in range(iters):
        if bool(done.all()):
            break
        rhs = sigma * x - q + rho * (z - u)
        x_new = rhs @ kinv  # kinv symmetric
        ax = _ALPHA * x_new + (1.0 - _ALPHA) * z
        z_new = _clip(ax + u, lo, hi)
        u = u + ax - z_new
        r_prim = (x_new - z_new).abs().amax(-1)
        r_dual = rho * (z_new - z).abs().amax(-1)
        x, z = x_new, z_new
        done = done | ((r_prim < tol) & (r_dual < tol))
        it = it + (~done).to(torch.int32)
    r_prim = (x - _clip(x, lo, hi)).abs().amax(-1)
    r_dual = (q + x @ P + rho * u).abs().amax(-1)
    return QPSolution(x, r_prim, r_dual, it, done)


# ------------------------------------------------------------- linear MPC

class LinearMPC(NamedTuple):
    """Condensed linear MPC: x_{k+1} = Ad x_k + Bd u_k, boxed controls,
    quadratic goal-tracking cost. The fields are f32 tensors."""

    Ad: torch.Tensor  # (nx, nx)
    Bd: torch.Tensor  # (nx, nu)
    Q: torch.Tensor  # (nx,) stage state weights
    Qf: torch.Tensor  # (nx,) terminal weights
    R: torch.Tensor  # (nu,) control weights
    horizon: int
    u_lo: torch.Tensor  # (nu,)
    u_hi: torch.Tensor


def _host64(a) -> np.ndarray:
    if torch.is_tensor(a):
        a = a.detach().cpu().numpy()
    return np.asarray(a, np.float64)


def condense(mpc: LinearMPC):
    """Prediction matrices X = Sx x0 + Su U (U stacked (T*nu,)), as f64
    numpy arrays: they do not depend on x0, and the host builds them once."""
    nx, nu = mpc.Bd.shape
    T = mpc.horizon
    Ad, Bd = _host64(mpc.Ad), _host64(mpc.Bd)
    powers = [np.eye(nx)]
    for _ in range(T):
        powers.append(Ad @ powers[-1])
    Sx = np.concatenate([powers[k] for k in range(1, T + 1)], axis=0)
    Su = np.zeros((T * nx, T * nu))
    for k in range(1, T + 1):
        for j in range(k):
            Su[(k - 1) * nx:k * nx, j * nu:(j + 1) * nu] = (
                powers[k - 1 - j] @ Bd)
    return Sx, Su


def solve_linear_mpc_batch(mpc: LinearMPC, x0, goal, iters: int = 1000,
                           tol: float = 1e-4, device=None):
    """Batched condensed linear-MPC solve -> (controls (..., T, nu), sol).

    Cost: sum_k (x_k - g)^T Q (x_k - g) + u^T R u with a terminal Qf;
    boxed controls. P is shared by the whole batch and A = I, so this takes
    the shared-operand ADMM. ``x0`` and ``goal`` (..., nx): tensors stay on
    their device unless ``device`` names one; anything else goes to
    ``resolve_device(device)`` (the card by default).
    """
    if not (torch.is_tensor(x0) and device is None):
        x0 = torch.as_tensor(x0, device=resolve_device(device))
    goal = torch.as_tensor(goal, dtype=x0.dtype, device=x0.device)
    nx, nu = mpc.Bd.shape
    T = mpc.horizon
    Sx, Su = condense(mpc)
    qw = np.concatenate([np.tile(_host64(mpc.Q), T - 1), _host64(mpc.Qf)])
    W_Su = qw[:, None] * Su
    P_np = Su.T @ W_Su + np.diag(np.tile(_host64(mpc.R), T))
    rho = float(np.clip(np.mean(np.diagonal(P_np)), 1e-3, 1e3))

    def dev32(a):
        return torch.as_tensor(np.asarray(a, np.float32)).to(x0.device)

    # q = Su^T diag(qw) (Sx x0 - g_rep), with the f32 matrices
    g_rep = goal.repeat((1,) * (goal.ndim - 1) + (T,))
    dtype = torch.promote_types(x0.dtype, torch.float32)
    resid = x0.to(dtype) @ dev32(Sx).to(dtype).T - g_rep.to(dtype)
    q = resid @ dev32(W_Su).to(dtype)
    lo = dev32(np.tile(_host64(mpc.u_lo), T)).expand(q.shape)
    hi = dev32(np.tile(_host64(mpc.u_hi), T)).expand(q.shape)
    sol = _solve_box_qp_shared(dev32(P_np), q, lo, hi, rho=rho, iters=iters,
                               tol=tol)
    return sol.x.reshape(q.shape[:-1] + (T, nu)), sol


def double_integrator_mpc(dt: float = 0.1, horizon: int = 10,
                          u_max: float = 2.0, device=None) -> LinearMPC:
    """2-D double-integrator MPC (the quadrotor domain): state [px, py, vx,
    vy], control [ax, ay]; f32 tensors on ``device`` (None: the card)."""
    dev = resolve_device(device)

    def t(v):
        return torch.tensor(v, dtype=torch.float32, device=dev)

    return LinearMPC(
        Ad=t([[1, 0, dt, 0], [0, 1, 0, dt], [0, 0, 1, 0], [0, 0, 0, 1]]),
        Bd=t([[0.5 * dt**2, 0], [0, 0.5 * dt**2], [dt, 0], [0, dt]]),
        Q=t([10.0, 10.0, 1.0, 1.0]), Qf=t([50.0, 50.0, 5.0, 5.0]),
        R=t([0.1, 0.1]), horizon=horizon, u_lo=t([-u_max, -u_max]),
        u_hi=t([u_max, u_max]))


__all__ = ["LinearMPC", "QPSolution", "condense", "double_integrator_mpc",
           "solve_linear_mpc_batch", "solve_qp_batch"]
