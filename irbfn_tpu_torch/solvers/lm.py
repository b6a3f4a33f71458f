"""Batched Levenberg-Marquardt nonlinear least squares.

Port of ``irbfn_tpu/solvers/lm.py``. The JAX package writes one problem as
a ``lax.while_loop`` and lifts it with ``vmap``; here the whole batch goes
through a host loop of at most ``max_iters`` passes, and a row that has
converged (or used its iterations) is frozen: each pass gathers the rows
still running, takes one damped Gauss-Newton step on them, and scatters the
result back. No per-row Python.

Per pass, for each running row:

- the residual ``r`` and its Jacobian ``J`` come from ``torch.func.jacfwd``
  of the caller's single-problem ``residual_fn`` under ``torch.func.vmap``;
- the Marquardt-damped normal equations
  ``(J^T J + lam (diag(J^T J) + 1e-12 I) + 1e-12 I) step = J^T r`` are
  solved by Cholesky; a row whose system is not positive definite gets a
  NaN step, which is rejected below;
- the step is taken if it lowers ``|r|^2`` (then ``lam *= 0.33``, at least
  ``lambda_min``), else ``lam *= 3`` (at most ``lambda_max``);
- the row stops once ``sqrt(min(old cost, new cost)) < tol``.

Failures are a boolean mask plus the final residual norm, not exceptions.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch
from torch.utils._pytree import tree_map


class LMResult(NamedTuple):
    x: torch.Tensor  # solution estimate (..., n)
    residual_norm: torch.Tensor  # final ||r||_2 (...,)
    iterations: torch.Tensor  # iterations taken (...,)
    converged: torch.Tensor  # bool mask (...,)


def _select(args, idx):
    return tree_map(lambda a: a[idx] if torch.is_tensor(a) else a, args)


@torch.no_grad()
def levenberg_marquardt(residual_fn: Callable, x0, args=None,
                        max_iters: int = 50, tol: float = 1e-10,
                        lambda0: float = 1e-3, lambda_min: float = 1e-12,
                        lambda_max: float = 1e8) -> LMResult:
    """Solve ``min_x ||residual_fn(x, args)||^2``, batched over leading
    axes.

    Args:
        residual_fn: ``(x (n,), args) -> r (m,)`` for a *single* problem,
            written with torch operations; batching is applied here with
            ``torch.func.vmap``.
        x0: initial guesses ``(..., n)`` (a tensor; the solve runs where it
            is).
        args: a pytree of per-problem tensors whose leading axes match
            ``x0``'s batch axes, or None.
    """
    from torch.func import jacfwd, vmap

    x0 = torch.as_tensor(x0)
    batch_shape = x0.shape[:-1]
    n = x0.shape[-1]
    x = x0.reshape(-1, n).clone()
    B = x.shape[0]
    nb = len(batch_shape)
    flat_args = tree_map(
        lambda a: (a.reshape((B,) + a.shape[nb:]) if torch.is_tensor(a)
                   else a), args)
    dtype, dev = x.dtype, x.device
    eye = torch.eye(n, dtype=dtype, device=dev)
    in_dims = (0, 0 if args is not None else None)

    def res_jac(xx, a):
        r = residual_fn(xx, a)
        return r, r

    res_and_jac = vmap(jacfwd(res_jac, has_aux=True), in_dims=in_dims)
    cost = vmap(lambda xx, a: torch.sum(residual_fn(xx, a) ** 2),
                in_dims=in_dims)

    lam = torch.full((B,), float(lambda0), dtype=dtype, device=dev)
    it = torch.zeros(B, dtype=torch.int64, device=dev)
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    for _ in range(max_iters):
        idx = torch.nonzero(~done).squeeze(-1)
        if idx.numel() == 0:
            break
        xa, la = x[idx], lam[idx]
        aa = _select(flat_args, idx)
        J, r = res_and_jac(xa, aa)  # (b, m, n), (b, m)
        Jt = J.transpose(-1, -2)
        g = (Jt @ r[..., None])[..., 0]
        H = Jt @ J
        # scaled (Marquardt) damping keeps the step well-conditioned when
        # residual dimensions have mixed scales
        A = H + la[:, None, None] * (torch.diag_embed(
            torch.diagonal(H, dim1=-2, dim2=-1)) + 1e-12 * eye)
        L, info = torch.linalg.cholesky_ex(A + 1e-12 * eye)
        step = torch.cholesky_solve(g[..., None], L)[..., 0]
        step = torch.where((info != 0)[:, None],
                           torch.full_like(step, float("nan")), step)
        x_new = xa - step
        c_old = torch.sum(r * r, dim=-1)
        c_new = cost(x_new, aa)
        improved = c_new < c_old  # false where c_new is NaN
        x[idx] = torch.where(improved[:, None], x_new, xa)
        lam[idx] = torch.where(improved,
                               torch.clamp(la * 0.33, min=lambda_min),
                               torch.clamp(la * 3.0, max=lambda_max))
        it[idx] += 1
        done[idx] = torch.sqrt(torch.minimum(c_old, c_new)) < tol
        done |= it >= max_iters
    rnorm = torch.sqrt(cost(x, flat_args))
    out = LMResult(x, rnorm, it, rnorm < tol)
    return LMResult(*[o.reshape(batch_shape + o.shape[1:]) for o in out])


__all__ = ["LMResult", "levenberg_marquardt"]
